"""Serving engine (ports ``repro/serve/engine.py``): prefill, then greedy
decode over a LEXI-compressed KV cache (MLA: the latent
cache; and, for the parallel attention ∥ SSM hybrids and the
attention-free SSM model, each layer's recurrent SSM state -- the
attention-free model has no KV at all), in two dataflows that share the
per-layer compute (``_attn_block``, whose FFN tail is the MLP or the
MoE decode of ``blocks.ffn_decode``):

Fixed batch (the reference's original research loop; ``launch/serve.py``
without ``--continuous``):
  ``prefill`` runs the trunk over B same-length prompts and builds each
  layer's batch-shared block store (group = B: one compressed record per
  block for all B sequences) as it goes; ``decode_step`` advances all B
  sequences in lockstep from one shared length — per layer the new token
  goes into the ring (a full ring is compressed into the next block) and
  ``cache.attend_cache`` attends [blocks ‖ ring] through the
  ``decode_attend`` kernel.  ``generate`` is prefill + N greedy steps
  (``FixedDecoder``).  The fixed loop also serves the two families the
  continuous engine refuses, as in the reference: the vision-stub VLM
  (``prefill(front_embeds=)``) and the encoder-decoder
  (``prefill(enc_embeds=)``: the encoder's memory is projected to each
  decoder layer's cross-attention K/V once, into a static block store,
  ``DecodeState.xkv``, which every decode step attends through the same
  ``decode_attend`` kernel, non-causal, at the memory's length).

Continuous batching (driven by ``serve.scheduler.ServeEngine``):
  admit  — ``prefill_sequences`` runs the trunk over a batch of
           same-length prompts, compressing each sequence's blocks on its
           own (and dispatching a MoE layer's tokens per sequence, as the
           reference's vmapped B = 1 admission prefills do);
           ``insert_sequences`` copies them into fresh pages;
  step   — ``paged_decode_step``: every active slot appends at its own
           length (the ring flushes into a fresh page when full) and
           attends through its page table; one greedy token per slot
           (``PagedDecoder`` runs the scheduler's decode and replay
           windows);
  evict  — ``release_slots`` frees a finished slot's pages;
  share  — ``map_shared_slot`` maps a cached prefix's pages into a slot,
           ``export_slot`` gathers a slot's pages (and views of its SSM
           state) for their copy to host bytes, ``import_slot`` writes
           them back (the scheduler's tiered
           PageCache, the disaggregated handoff); ``restore_ssm`` scatters
           a boundary SSM snapshot into a slot.

SSM state (hybrids): stacked (L, B or n_slots, ...) ``models.ssm.SSMState``
buffers allocated once, next to the caches.  Each decode step runs
``ssm.ssm_decode_step`` beside attention (outputs summed in f32) and
copies the new state into those buffers in place; the paged step copies
only the rows of the slots that step (``plan.post > plan.pos``, a device
mask; at tp > 1 ``plan.active`` is narrower: the slots whose token this
rank's cache takes), so inactive and fed-off
slots keep their state, under a CUDA graph too.

Compiled dispatch: the reference jits each decode window (a ``lax.scan``
of K steps) and the fixed loop; here ``PagedDecoder`` and
``FixedDecoder`` replay one captured CUDA graph of a step
(``kernels.ops.CapturedStep``) for every step that flushes no ring, and
run the flushing steps eagerly.  Graph and eager steps run the same code
on the same buffers, so streams and cache bytes are the same either way.

Port-specific: lengths live on the host — ``DecodeState.length`` as an
int, ``PagedState``'s slot lengths and occupancy in numpy next to the
host-side page table (see ``models.cache``) — so ring-flush decisions and
page allocation cost no device sync; the device sees them through
tensors that stay put (the fixed store's device length, the pool's page
table and step buffer), refreshed in place.  State updates happen in
place.

Tensor parallelism (every family; ``tg`` a ``launch.mesh.TPGroup``, one
process per rank, every rank running the same loop): prefill runs the
sequence-sharded trunk (``lm.lm_forward``: a MoE layer's tokens cross to
the experts' ranks in its all-to-alls, an SSM runs the rank's heads and
keeps their state, an encoder-decoder's encoder runs sequence-sharded
and its memory is gathered to every rank), then reshards each layer's
K/V -- and an encoder-decoder's cross-attention K/V of the memory --
into the cache's interleaved slots -- one all-to-all of the rank's kv
heads in ``col`` mode (``_interleave_heads_a2a``), a slice of the full
payload in ``row`` mode and of MLA's latent, which every rank holds
whole (``_interleave_slice``) -- and broadcasts the last position's
hidden state from rank tp - 1 (a psum where the other ranks add zeros).
Decode steps psum the mixer, cross-attention, MLP and MoE partials in
bf16, merge the ranks' attention partials (``cache.merge_shards``; the
cross store's too, attended by every query head gathered) and pick the
greedy token over the vocab shards (``greedy_token``: pmax, then pmin of
the candidate ids).  Every rank gets the same tokens.  Decode at tp > 1
runs eagerly: a gloo collective cannot be captured in a CUDA graph.  At
tp = 1 every collective is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import collectives as cl
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, blocks, cache as cache_mod, layers
from repro_torch.models import lm, ssm as ssm_mod
from repro_torch.models.ssm import SSMState


@dataclasses.dataclass
class DecodeState:
    """Fixed-batch decode state: every layer's batch-shared block store
    (group = B; None for an attention-free model); all B sequences hold
    ``length`` tokens, a host int that decides the ring flushes, kept
    equal to ``length_dev``, the same count as a 0-d int32 on the stores'
    device that the step's device work reads (rope positions, ring row,
    attention length).  A hybrid's or an SSM model's ``ssm`` holds every
    layer's recurrent state, stacked (L, B, ...).  An encoder-decoder's
    ``xkv`` holds every decoder layer's cross-attention store of the
    encoder's memory (static after prefill; ``xlen`` rows)."""
    kv: Optional[List[cache_mod.KVBlocks]]     # one per layer
    length: int
    length_dev: Optional[torch.Tensor] = None
    ssm: Optional[SSMState] = None
    xkv: Optional[List[cache_mod.KVBlocks]] = None
    xlen: int = 0

    def __post_init__(self):
        if self.length_dev is None:
            dev = (self.kv[0].ring.device if self.kv is not None
                   else self.ssm.h.device)
            self.length_dev = torch.tensor(self.length, dtype=torch.int32,
                                           device=dev)


@dataclasses.dataclass
class PrefilledSequences:
    """``prefill_sequences`` output: per-layer single-sequence block
    stores (group = 1; None for an attention-free model), ``length``
    tokens each, and a hybrid's or an SSM model's final SSM states (L, B,
    ...), for ``insert_sequences``."""
    kv: Optional[List[cache_mod.KVBlocks]]     # one per layer, leading B
    length: int
    ssm: Optional[SSMState] = None


@dataclasses.dataclass
class PagedState:
    """Slot-based decode state.  ``lengths``/``active`` are per slot and
    shared by every layer (a sequence is at the same position in all);
    a hybrid's or an SSM model's ``ssm`` is stacked (L, n_slots, ...).
    An attention-free model has no pool (``kv`` None, as in the
    reference); ``step`` is the (4, n_slots) buffer a step's per-slot
    values are staged into (``cache.stage_append``): the pool's
    ``PagedKV.step``, or the state's own without a pool."""
    kv: Optional[cache_mod.PagedKV]
    lengths: np.ndarray                # (n_slots,) int32 tokens per slot
    active: np.ndarray                 # (n_slots,) bool slot occupied
    ssm: Optional[SSMState] = None
    step: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step is None:
            self.step = (self.kv.step if self.kv is not None else
                         cache_mod.empty_step(len(self.lengths),
                                              self.ssm.h.device))


def greedy_token(logits: torch.Tensor, tg=None) -> torch.Tensor:
    """(B, 1, V) -> (B, 1) int32 argmax (first maximum on ties).  At
    tp > 1 ``logits`` are the rank's vocab shard: the largest logit over
    the ranks (pmax), then the smallest id that reaches it (pmin), so ties
    go to the lowest id, on every rank."""
    if cl.world(tg) == 1:
        return logits.argmax(-1).to(torch.int32)
    v_loc = logits.shape[-1]
    loc_max = logits.max(-1).values
    loc_idx = logits.argmax(-1).to(torch.int32) + tg.rank * v_loc
    maxes, idxs = cl.gather_many((loc_max, loc_idx), tg)   # one exchange
    cand = torch.where(maxes >= maxes.max(0).values, idxs,
                       torch.full_like(idxs, 1 << 30))
    return cand.min(0).values


def kv_payload(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,Hkv,S,hd) k, v -> (B, S, W) cache payload, W laid out
    (Hkv, 2, hd) like ``attention.decode_qkv``'s new values."""
    b, hkv, s, hd = k.shape
    return torch.stack([k, v], dim=2).permute(0, 3, 1, 2, 4) \
        .reshape(b, s, hkv * 2 * hd)


def _interleave_heads_a2a(vals: torch.Tensor, tg) -> torch.Tensor:
    """(B, S, W/tp) payload of the rank's kv heads -> (B, S/tp, W) of the
    rank's interleaved slots (positions c * tp + rank), every kv head:
    one all-to-all (slot c's part for rank j goes to rank j; the parts
    received from the ranks, in rank order, are the kv heads in order)."""
    b, s, wl = vals.shape
    tp = tg.world
    chunks = vals.reshape(b, s // tp, tp, wl).permute(2, 0, 1, 3)
    got = cl.exchange_parts(chunks.contiguous(), tg)  # (src rank, B, S/tp, .)
    return got.permute(1, 2, 0, 3).reshape(b, s // tp, tp * wl)


def _interleave_slice(vals: torch.Tensor, tg) -> torch.Tensor:
    """(B, S, W) replicated payload -> the rank's interleaved slots (B,
    S/tp, W)."""
    b, s, w = vals.shape
    return vals.reshape(b, s // tg.world, tg.world, w)[:, :, tg.rank]


def cache_payload(cfg: ModelConfig, kv, tg=None) -> torch.Tensor:
    """A layer's prefill cache output -> its (B, S, W) cache payload: the
    MLA latent as it is, else ``kv_payload(k, v)``; at tp > 1 the rank's
    interleaved slots of it (B, S/tp, W).  (An encoder-decoder's
    cross-attention (k, v) of the memory takes the same layout.)"""
    vals = kv if cfg.mla is not None else kv_payload(*kv)
    if cl.world(tg) == 1:
        return vals
    if cfg.mla is None and attention.kv_mode(cfg, tg.world) == "col":
        return _interleave_heads_a2a(vals, tg)
    return _interleave_slice(vals, tg)


def _last_hidden(x: torch.Tensor, tg) -> torch.Tensor:
    """The last position's hidden state (B, 1, D): at tp > 1 it lies on
    rank tp - 1, whose value every rank gets through an f32 psum where the
    other ranks add zeros (exact)."""
    xl = x[:, -1:]
    if cl.world(tg) == 1:
        return xl
    mine = xl.float() if tg.rank == tg.world - 1 else torch.zeros_like(
        xl, dtype=torch.float32)
    return cl.psum(mine, tg).to(torch.bfloat16)


def _prefill(cfg: ModelConfig, run: RunConfig, params, tokens: torch.Tensor,
             stores: Optional[List[cache_mod.KVBlocks]],
             ssm: Optional[SSMState] = None,
             groups: int = 1, tg=None, front_embeds=None, enc_embeds=None,
             xstores: Optional[List[cache_mod.KVBlocks]] = None
             ) -> torch.Tensor:
    """tokens (B, S) -> last-position logits (B,1,Vp); layer i's cache
    payload (K/V, or MLA's latent) fills the empty block store
    ``stores[i]`` in place (none without attention), a hybrid's or an SSM
    model's final SSM state layer i of ``ssm`` (L, B, ...), and an
    encoder-decoder's cross-attention K/V of the memory the store
    ``xstores[i]``; the B sequences run as ``groups`` separate prefills
    (``lm.lm_forward``, which takes ``front_embeds`` and ``enc_embeds``).
    At tp > 1 the logits are the rank's vocab shard and the stores take
    the rank's interleaved slots.

    Each layer's payload is compressed inside the layer loop
    (``lm_forward``'s ``cache_fn``), so the raw payload of one layer only
    is alive at a time."""
    def to_blocks(i, kv, st):
        if st is not None:
            ssm_mod.write_state(ssm_mod.take(ssm, i), st)
        if kv is not None:
            cache_mod.fill_from_prefill(cfg, run, stores[i],
                                        cache_payload(cfg, kv, tg))

    def to_xblocks(i, xkv):
        cache_mod.fill_from_prefill(cfg, run, xstores[i],
                                    cache_payload(cfg, xkv, tg))

    x, _ = lm.lm_forward(cfg, run, params, tokens, want_cache=True,
                         cache_fn=to_blocks, groups=groups, tg=tg,
                         xcache_fn=to_xblocks, front_embeds=front_embeds,
                         enc_embeds=enc_embeds)
    return lm.logits_for(cfg, params, _last_hidden(x, tg), tg)


def _empty_ssm(cfg: ModelConfig, batch: int, device,
               tp: int = 1) -> Optional[SSMState]:
    """Zeroed (L, batch, ...) SSM state of a hybrid (one rank's heads of
    ``tp``), None otherwise."""
    if cfg.ssm is None:
        return None
    return ssm_mod.empty_state(cfg, (cfg.n_layers, batch), device, tp)


def resolve_device(device) -> torch.device:
    """The serving (or training) device: CUDA unless the caller asks for
    the CPU; a CUDA request on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev


def _empty_stores(cfg: ModelConfig, run: RunConfig, batch: int,
                  max_len: int, group: int, device,
                  tp: int = 1) -> Optional[List[cache_mod.KVBlocks]]:
    """One zeroed block store per layer, or None for an attention-free
    model."""
    if cfg.n_heads == 0:
        return None
    return [cache_mod.empty_kv(cfg, run, batch, max_len, group=group,
                               device=device, tp=tp)
            for _ in range(cfg.n_layers)]


def empty_state(cfg: ModelConfig, run: RunConfig, batch: int, max_len: int,
                device="cuda", tp: int = 1) -> DecodeState:
    """Zeroed fixed-batch state: one batch-shared store per layer (one
    rank's of ``tp``; none without attention) and, for an
    encoder-decoder, one cross-attention store per decoder layer of the
    same capacity (the reference's), on the card unless the caller asks
    for the CPU."""
    device = resolve_device(device)
    return DecodeState(
        kv=_empty_stores(cfg, run, batch, max_len, batch, device, tp),
        length=0, ssm=_empty_ssm(cfg, batch, device, tp),
        xkv=(_empty_stores(cfg, run, batch, max_len, batch, device, tp)
             if cfg.encdec else None))


def prefill(cfg: ModelConfig, run: RunConfig, params, tokens: torch.Tensor,
            max_len: int, tg=None, front_embeds=None,
            enc_embeds=None) -> Tuple[torch.Tensor, DecodeState]:
    """Fixed batch: tokens (B, S) -> (last-position logits (B,1,Vp),
    DecodeState) with room for ``max_len`` tokens per sequence.  A MoE
    layer dispatches the B * S tokens jointly, as the reference's
    ``prefill`` does.  At tp > 1 (S % tp == 0) the logits are the rank's
    vocab shard and the state the rank's.  A vision-stub VLM takes
    ``front_embeds`` (B, n_frontend_tokens, D), an encoder-decoder
    ``enc_embeds`` (B, Sm, D), Sm <= ``max_len`` (as the reference's
    ``prefill``; at tp > 1 Sm % tp == 0, and each rank's cross-attention
    stores take its interleaved rows of the memory's K/V)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    if cfg.encdec and (enc_embeds is None or enc_embeds.shape[1] > max_len):
        raise ValueError(f"{cfg.name}: prefill needs enc_embeds of at most "
                         f"max_len={max_len} frames")
    state = empty_state(cfg, run, b, max_len, device=tokens.device,
                        tp=cl.world(tg))
    logits = _prefill(cfg, run, params, tokens, state.kv, state.ssm, tg=tg,
                      front_embeds=front_embeds, enc_embeds=enc_embeds,
                      xstores=state.xkv)
    state.length = s
    state.length_dev.fill_(s)
    if cfg.encdec:
        state.xlen = int(enc_embeds.shape[1])
    return logits, state


def prefill_sequences(cfg: ModelConfig, run: RunConfig, params,
                      tokens: torch.Tensor, tg=None
                      ) -> Tuple[torch.Tensor, PrefilledSequences]:
    """Continuous batching: tokens (B, S) -> (last-position logits
    (B,1,Vp), each sequence's blocks compressed on its own).  Every
    sequence is its own B = 1 prefill, as the reference's vmapped admission
    runs it: a MoE layer dispatches each sequence's tokens on their own,
    with its own capacity, and at tp > 1 each sequence's activations are
    compressed on their own in the gathers.  At tp > 1 each rank keeps its
    slots."""
    b, s = tokens.shape
    stores = _empty_stores(cfg, run, b, s, 1, tokens.device, cl.world(tg))
    ssm = _empty_ssm(cfg, b, tokens.device, cl.world(tg))
    logits = _prefill(cfg, run, params, tokens, stores, ssm, groups=b,
                      tg=tg)
    return logits, PrefilledSequences(kv=stores, length=s, ssm=ssm)


def decode_spec(cfg: ModelConfig) -> layers.AttnSpec:
    """The decode attention spec: the config's, with MLA's scale."""
    spec = attention.base_attn_spec(cfg)
    if cfg.mla is not None:
        spec = spec._replace(scale=attention.mla_scale(cfg))
    return spec


def _attn_block(cfg: ModelConfig, p, x: torch.Tensor, pos: torch.Tensor,
                attend, sst: Optional[SSMState] = None,
                active: Optional[torch.Tensor] = None, tg=None,
                cross=None) -> torch.Tensor:
    """One layer's decode step around its cache: x (B,1,D), ``pos`` (B,)
    rope positions; ``attend(q, new_vals)`` appends the new K/V (MLA: the
    latent) and returns the merged attention (B,Hq,1,hd_v) bf16 (None for
    an attention-free layer, which has no attention).  A hybrid's or an
    SSM model's ``sst`` (this layer's state buffers) steps beside
    attention, its output summed in f32, and takes the new state in place
    (only ``active``'s rows if given).  An encoder-decoder's ``cross(q)``
    attends the layer's cross-attention store of the memory (ports the
    reference's ``decode_block`` cross path: ``cross_decode_q`` -- at
    tp > 1 the rank's query heads gathered to every head --, then
    ``attend_cache``, then ``decode_out``, whose partial is psum'd).
    Then the FFN tail: MLP or MoE.  At tp > 1 the partials are psum'd in
    bf16 (``blocks.mixer_residual``, ``blocks.ffn_decode``)."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    o = None
    if attend is not None:
        q, new_vals = attention.decode_qkv(cfg, p["attn"], h, pos, tg)
        o = attention.decode_out(cfg, p["attn"], attend(q, new_vals), tg)
    if sst is not None:
        o_ssm, new = ssm_mod.ssm_decode_step(cfg, p["ssm"], h, sst, tg)
        ssm_mod.write_state(sst, new, active)
        o = o_ssm if o is None else o + o_ssm
    x = blocks.mixer_residual(cfg, p, x, o, tg)
    if cross is not None:
        hx = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
        xa = p["xattn"]
        b = hx.shape[0]
        q = layers.pdot(hx, xa["wq"], xa.get("bq")).reshape(
            b, 1, -1, cfg.head_dim).transpose(1, 2)
        if cl.world(tg) > 1:
            q = cl.fold_parts(cl.gather_many((q,), tg)[0], 1)
        xo = attention.decode_out(cfg, xa, cross(q), tg)
        x = x + cl.psum(xo.to(torch.bfloat16), tg)
    return blocks.ffn_decode(cfg, p, x, tg)


def decode_block(cfg: ModelConfig, run: RunConfig, p, x: torch.Tensor,
                 kv: Optional[cache_mod.KVBlocks], length: int,
                 length_dev: torch.Tensor, post: torch.Tensor,
                 spec: layers.AttnSpec, window=None,
                 sst: Optional[SSMState] = None, tg=None,
                 xkv: Optional[cache_mod.KVBlocks] = None,
                 xlen: int = 0) -> torch.Tensor:
    """One layer's fixed-batch decode step: the new token at position
    ``length`` (host int, for the flush; ``length_dev`` the same on the
    device) of every sequence, ``post`` = length + 1 on the device; ``kv``
    (None without attention) and a hybrid's or an SSM model's state
    ``sst`` updated in place.  An encoder-decoder's ``xkv`` (the layer's
    cross-attention store, ``xlen`` rows of the memory; at tp > 1 the
    rank's interleaved rows) is attended non-causally with no softcap at
    that static length, through the kernel's ``tp, ti`` path."""
    pos = length_dev.expand(x.shape[0])

    def attend(q, new_vals):
        cache_mod.append_token(cfg, run, kv, new_vals, length, length_dev,
                               tp=cl.world(tg), ti=cl.rank(tg))
        return cache_mod.attend_cache(cfg, run, kv, q, post, spec,
                                      window=window, tg=tg)

    def cross(q):
        return cache_mod.attend_cache(
            cfg, run, xkv, q, xlen,
            layers.AttnSpec(causal=False, softcap=None), tg=tg)

    return _attn_block(cfg, p, x, pos, None if kv is None else attend, sst,
                       tg=tg, cross=None if xkv is None else cross)


def _fixed_forward(cfg: ModelConfig, run: RunConfig, params,
                   state: DecodeState, tokens: torch.Tensor,
                   tg=None) -> torch.Tensor:
    """The device work of one fixed-batch step: tokens (B, 1) -> logits,
    ``state.length_dev`` advanced; the host length is read (to decide the
    flush) but not advanced.  Without a flush it has the same shapes and
    addresses at every length (``FixedDecoder`` captures it)."""
    x = lm.embed_tokens(cfg, params["embed"], tokens, tg)  # (B,1,D)
    spec = decode_spec(cfg)
    wins = attention.layer_windows(cfg)
    post = state.length_dev + 1
    for i in range(cfg.n_layers):
        x = decode_block(cfg, run, lm.layer_params(params, i), x,
                         None if state.kv is None else state.kv[i],
                         state.length, state.length_dev, post,
                         spec, window=None if wins is None else int(wins[i]),
                         sst=None if state.ssm is None
                         else ssm_mod.take(state.ssm, i), tg=tg,
                         xkv=None if state.xkv is None else state.xkv[i],
                         xlen=state.xlen)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    state.length_dev.copy_(post)
    return lm.logits_for(cfg, params, x, tg)


def decode_step(cfg: ModelConfig, run: RunConfig, params, state: DecodeState,
                tokens: torch.Tensor, tg=None) -> torch.Tensor:
    """tokens (B, 1) -> logits (B, 1, Vp) (at tp > 1 the rank's vocab
    shard); every sequence advances one token (state updated in place)."""
    logits = _fixed_forward(cfg, run, params, state, tokens, tg)
    state.length += 1
    return logits


def resolve_graphs(cuda_graphs: Optional[bool], device, tp: int = 1) -> bool:
    """Whether decode replays CUDA graphs: by default on a CUDA device at
    tp = 1, not on the CPU and not at tp > 1 (a gloo collective cannot be
    captured; graphs at tp > 1 wait for NCCL on several cards, ROADMAP.md
    queue 1, item 3); ``True`` on the CPU or at tp > 1 raises."""
    on_cuda = torch.device(device).type == "cuda"
    if cuda_graphs is None:
        return on_cuda and tp == 1
    if cuda_graphs and not on_cuda:
        raise ValueError("cuda_graphs=True needs a CUDA device")
    if cuda_graphs and tp > 1:
        raise ValueError("cuda_graphs=True at tp > 1: a collective between "
                         "the ranks cannot be captured yet (ROADMAP.md, "
                         "queue 1, item 3)")
    return bool(cuda_graphs)


@dataclasses.dataclass
class StepCounts:
    """Decode steps a decoder ran: eagerly (every step without graphs;
    with them, the steps whose ring flush cannot be captured), flushing
    (a subset of the eager ones) and as replays of the captured step."""
    eager: int = 0
    flush: int = 0
    replays: int = 0
    captures: int = 0


class FixedDecoder:
    """The fixed-batch loop's steps (``generate``): each step feeds
    ``tok`` (B, 1) int32 and leaves its greedy tokens there.  A step whose
    ring write fills the ring (``length % blk == blk - 1``, known on the
    host; never for an attention-free model) runs eagerly; with
    ``graphs``, every other step replays one captured ``decode_step`` +
    greedy, captured at the first such step (an encoder-decoder's static
    cross-attention stores and length are part of it)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params,
                 state: DecodeState, tok: torch.Tensor, graphs: bool,
                 tg=None):
        if graphs and cl.world(tg) > 1:
            raise ValueError("FixedDecoder: no CUDA graphs at tp > 1")
        self.cfg, self.run, self.params, self.state = cfg, run, params, state
        self.tok = tok.to(torch.int32).clone()
        self.graphs = graphs
        self.graph = None
        self.tg = tg
        self.counts = StepCounts()

    def _body(self) -> None:
        self.tok.copy_(greedy_token(_fixed_forward(
            self.cfg, self.run, self.params, self.state, self.tok, self.tg),
            self.tg))

    def _warmup(self) -> None:
        """One step on the capture stream, then the state put back: the
        ring row it wrote (every layer), a hybrid's SSM state, the device
        length and the tokens."""
        st, blk = self.state, self.run.codec.cache_block
        r = st.length % blk
        keep = [kv.ring[:, r].clone() for kv in st.kv or ()]
        ssm_keep = None if st.ssm is None else [t.clone() for t in st.ssm]
        tok, length = self.tok.clone(), st.length_dev.clone()
        self._body()
        for kv, row in zip(st.kv or (), keep):
            kv.ring[:, r] = row
        if ssm_keep is not None:
            for t, v in zip(st.ssm, ssm_keep):
                t.copy_(v)
        self.tok.copy_(tok)
        st.length_dev.copy_(length)

    def step(self) -> None:
        st, blk = self.state, self.run.codec.cache_block
        if st.kv is not None and \
                (st.length // cl.world(self.tg) + 1) // blk > st.kv[0].nblk:
            raise ValueError(f"length {st.length + 1} does not fit the "
                             f"store's blocks of {blk} and the ring")
        flush = st.kv is not None and st.length % blk == blk - 1
        if self.graphs and not flush:
            if self.graph is None:
                self.graph = kops.CapturedStep(self._body, self._warmup,
                                               self.tok.device)
                self.counts.captures += 1
            self.graph.replay()
            self.counts.replays += 1
        else:
            self._body()
            self.counts.eager += 1
            self.counts.flush += flush
        self.state.length += 1


def generate(cfg: ModelConfig, run: RunConfig, params, prompts: torch.Tensor,
             new_tokens: int, max_len: int, tg=None, front_embeds=None,
             enc_embeds=None) -> torch.Tensor:
    """The reference launcher's fixed-batch loop: prefill (with a VLM's
    ``front_embeds``, an encoder-decoder's ``enc_embeds``), then
    ``new_tokens`` greedy decode steps (``FixedDecoder``: from a CUDA
    graph on the card at tp = 1, eagerly on the CPU or at tp > 1).
    prompts (B, S) -> (B, new_tokens + 1) int32: the greedy token after
    the prompt and after each step (the same on every rank)."""
    logits, state = prefill(cfg, run, params, prompts, max_len, tg,
                            front_embeds=front_embeds, enc_embeds=enc_embeds)
    dec = FixedDecoder(cfg, run, params, state, greedy_token(logits, tg),
                       resolve_graphs(None, prompts.device, cl.world(tg)),
                       tg)
    outs = [dec.tok.clone()]
    for _ in range(new_tokens):
        dec.step()
        outs.append(dec.tok.clone())
    return torch.cat(outs, dim=1)


def empty_paged_state(cfg: ModelConfig, run: RunConfig, n_slots: int,
                      max_len: int, n_pages: Optional[int] = None,
                      device="cuda", tp: int = 1) -> PagedState:
    """Zeroed paged state with a page pool sized for ``n_slots`` (and a
    hybrid's SSM state for every slot, allocated once), one rank's of
    ``tp``, on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    return PagedState(
        kv=cache_mod.empty_paged_kv(cfg, run, n_slots, max_len,
                                    n_pages=n_pages, device=device, tp=tp),
        lengths=np.zeros((n_slots,), np.int32),
        active=np.zeros((n_slots,), bool),
        ssm=_empty_ssm(cfg, n_slots, device, tp))


def paged_state_nbytes(state: PagedState) -> int:
    """Device bytes of the paged state (pools, rings and SSM state), from
    shapes."""
    kv = state.kv
    pool = () if kv is None else (kv.signman, kv.planes, kv.dict_syms,
                                  kv.esc_pos, kv.esc_raw, kv.raw_pages,
                                  kv.ring)
    return sum(t.numel() * t.element_size() for t in pool
               if t is not None) + ssm_mod.state_nbytes(state.ssm)


def paged_decode_block(cfg: ModelConfig, run: RunConfig, p, layer: int,
                       x: torch.Tensor, kv: Optional[cache_mod.PagedKV],
                       plan: cache_mod.AppendPlan, spec: layers.AttnSpec,
                       window=None,
                       sst: Optional[SSMState] = None, tg=None) -> torch.Tensor:
    """One layer's decode step at per-slot positions.  x (S,1,D); the
    plan's ``pos`` (S,) are the rope positions, ``post`` (S,) the lengths
    including the new token.  Inactive slots leave their cache and SSM
    state untouched (their outputs are garbage the scheduler drops): the
    new state is written only for the slots that step (``plan.post >
    plan.pos``; at tp > 1 ``plan.active`` holds only the slots whose
    position this rank's cache takes, while every rank steps its SSM
    heads).  An attention-free model has no pool (``kv`` None)."""
    def attend(q, new_vals):
        cache_mod.append_token_paged(cfg, run, kv, layer, new_vals, plan)
        return cache_mod.attend_paged(cfg, run, kv, layer, q, plan.post,
                                      spec, window=window, tg=tg)

    live = None if sst is None else plan.post > plan.pos
    return _attn_block(cfg, p, x, plan.pos,
                       None if kv is None else attend, sst, live, tg)


def _paged_forward(cfg: ModelConfig, run: RunConfig, params,
                   kv: Optional[cache_mod.PagedKV],
                   plan: cache_mod.AppendPlan,
                   tokens: torch.Tensor,
                   ssm: Optional[SSMState] = None, tg=None) -> torch.Tensor:
    """The device work of one paged step: tokens (S, 1) -> logits (S, 1,
    Vp).  Every value it reads comes through ``plan`` (views of the
    pool's step buffer) and the pool's persistent tensors, so without a
    flush it has the same shapes and addresses every step
    (``PagedDecoder`` captures it)."""
    x = lm.embed_tokens(cfg, params["embed"], tokens, tg)  # (S,1,D)
    spec = decode_spec(cfg)
    wins = attention.layer_windows(cfg)
    for i in range(cfg.n_layers):
        x = paged_decode_block(
            cfg, run, lm.layer_params(params, i), i, x, kv, plan, spec,
            window=None if wins is None else int(wins[i]),
            sst=None if ssm is None else ssm_mod.take(ssm, i), tg=tg)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm.logits_for(cfg, params, x, tg)


def paged_decode_step(cfg: ModelConfig, run: RunConfig, params,
                      state: PagedState, tokens: torch.Tensor, tg=None
                      ) -> torch.Tensor:
    """tokens (S, 1) -> logits (S, 1, Vp) (at tp > 1 the rank's vocab
    shard); every active slot advances one token at its own position
    (state updated in place)."""
    dec = PagedDecoder(cfg, run, state, graphs=False, tg=tg)
    dec.tok.copy_(tokens)
    return dec.forward(params)


class PagedDecoder:
    """The continuous-batching engine's decode and replay steps over one
    ``PagedState``.  Each step feeds ``tok`` (S, 1) int32 and leaves its
    greedy tokens there.  A step in which an appending slot's ring fills
    runs eagerly (its flush compresses pages, with shapes that depend on
    the flushing slots); with ``graphs``, every other step replays one
    captured step (embed -> the layers -> final norm -> logits -> greedy
    into ``tok``), captured at the first such step and again whenever the
    parameters change.  Host lengths advance on every step and are staged
    to the device before it (``cache.stage_append``), so eviction and
    admission between steps are visible to the graph."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, state: PagedState,
                 graphs: bool, tg=None):
        if graphs and cl.world(tg) > 1:
            raise ValueError("PagedDecoder: no CUDA graphs at tp > 1")
        self.cfg, self.run, self.state = cfg, run, state
        self.tok = torch.zeros((len(state.lengths), 1), dtype=torch.int32,
                               device=state.step.device)
        self.graphs = graphs
        self.graph, self.params = None, None
        self.tg = tg
        self.counts = StepCounts()

    def _stage(self, lengths, active):
        return cache_mod.stage_append(self.run, self.state.kv, lengths,
                                      active, cl.world(self.tg),
                                      cl.rank(self.tg), self.state.step)

    def _body(self, plan: cache_mod.AppendPlan) -> None:
        self.tok.copy_(greedy_token(_paged_forward(
            self.cfg, self.run, self.params, self.state.kv, plan, self.tok,
            self.state.ssm), self.tg))

    def _capture(self, params, active: np.ndarray) -> None:
        """Capture the step.  Its warm-up runs the step with no slot
        active (every ring row written back as it was, nothing flushed)
        and puts the tokens back; then the step in hand is staged again."""
        self.params = params
        st = self.state
        tok = self.tok.clone()

        def warmup():
            self._stage(st.lengths, np.zeros_like(active))
            self._body(cache_mod.device_plan(st.step))
            self.tok.copy_(tok)

        self.graph = kops.CapturedStep(
            lambda: self._body(cache_mod.device_plan(st.step)), warmup,
            self.tok.device)
        self.counts.captures += 1
        self._stage(st.lengths, active)

    def forward(self, params, active: Optional[np.ndarray] = None
                ) -> Optional[torch.Tensor]:
        """One step of the slots in ``active`` (default: the occupied
        ones) from ``tok``: replayed from the graph, which leaves its
        greedy tokens in ``tok`` (returns None), or run eagerly (returns
        its logits (S, 1, Vp); ``tok`` unchanged)."""
        st = self.state
        act = st.active if active is None else active
        flush = self._stage(st.lengths, act)
        logits = None
        if self.graphs and not len(flush[0]):
            if self.graph is None or params is not self.params:
                self._capture(params, act)
            self.graph.replay()
            self.counts.replays += 1
        else:
            logits = _paged_forward(self.cfg, self.run, params, st.kv,
                                    cache_mod.device_plan(st.step, *flush),
                                    self.tok, st.ssm, self.tg)
            self.counts.eager += 1
            self.counts.flush += bool(len(flush[0]))
        st.lengths += act.astype(np.int32)
        return logits

    def step(self, params, active: Optional[np.ndarray] = None) -> None:
        """``forward``, with its greedy tokens left in ``tok``."""
        logits = self.forward(params, active)
        if logits is not None:
            self.tok.copy_(greedy_token(logits, self.tg))

    def decode(self, params, tokens: torch.Tensor, n_steps: int
               ) -> torch.Tensor:
        """``n_steps`` greedy steps of the occupied slots from tokens (S,
        1): (n_steps, S, 1) int32, on the device."""
        self.tok.copy_(tokens)
        out = torch.empty((n_steps,) + tuple(self.tok.shape),
                          dtype=torch.int32, device=self.tok.device)
        for i in range(n_steps):
            self.step(params)
            out[i].copy_(self.tok)
        return out

    def replay(self, params, tokens: torch.Tensor, feed: np.ndarray
               ) -> torch.Tensor:
        """Feed K known tokens per slot: ``tokens`` (K, S, 1) where ``feed``
        (K, S) is True; a slot not fed at a step is inactive for it (cache
        and length untouched).  Returns the per-step greedy tokens (K, S,
        1) on the device."""
        out = torch.empty(tuple(tokens.shape), dtype=torch.int32,
                          device=self.tok.device)
        for t in range(tokens.shape[0]):
            self.tok.copy_(tokens[t])
            self.step(params, self.state.active & feed[t])
            out[t].copy_(self.tok)
        return out


def insert_sequences(cfg: ModelConfig, run: RunConfig, state: PagedState,
                     d: PrefilledSequences, slots, tp: int = 1) -> PagedState:
    """Insert a prefilled batch (``prefill_sequences``' output, B sequences
    of ``d.length`` tokens, the rank's slots of them at tp > 1) into free
    slots ``slots`` (in place)."""
    slots = np.asarray(slots, np.int64)
    if state.kv is not None:
        cache_mod.paged_insert_many(cfg, run, state.kv, d.kv, slots,
                                    d.length, tp)
    if state.ssm is not None:
        idx = torch.as_tensor(slots, device=state.ssm.h.device)
        for dst, src in zip(state.ssm, d.ssm):
            dst[:, idx] = src
    state.lengths[slots] = d.length
    state.active[slots] = True
    return state


def paged_replay_steps(cfg: ModelConfig, run: RunConfig, params,
                       state: PagedState, tokens: torch.Tensor,
                       feed: np.ndarray, tg=None) -> torch.Tensor:
    """Replay K known tokens per slot through the decode path, eagerly.

    ``tokens`` (K, S, 1) are fed where ``feed`` (K, S) is True; slots not
    fed at a step are inactive for it (cache and length untouched).
    Returns the per-step greedy tokens (K, S, 1); the scheduler reads a
    slot's first generated token from the step that consumed its last
    prompt token."""
    return PagedDecoder(cfg, run, state, graphs=False, tg=tg).replay(
        params, tokens, feed)


def map_shared_slot(state: PagedState, slot: int, page_ids: np.ndarray,
                    n_cols: int, base_len: int) -> PagedState:
    """Admit a prefix-cache hit: map ``n_cols`` already-filled page
    columns (ids ``page_ids`` (maxp,)) into ``slot``'s table row, with no
    prefill and no page copy.  The slot starts at ``base_len`` tokens;
    the prompt suffix replays through decode steps.  A hybrid's SSM state
    is left untouched: the scheduler restores a boundary snapshot
    (``restore_ssm`` / ``import_slot``), since pages alone cannot rebuild a
    recurrence."""
    cache_mod.map_prefix_pages(state.kv, slot, page_ids, n_cols)
    state.lengths[slot] = base_len
    state.active[slot] = True
    return state


def export_slot(state: PagedState, slot: int, n_cols: int, col0: int = 0,
                tp: int = 1, ti: int = 0
                ) -> Tuple[cache_mod.PageWire, Optional[SSMState], int]:
    """One slot's cache payload for a handoff or a spill: (the
    ``cache.export_sequence`` of page columns ``[col0, col0 + n_cols)``
    and the ring, or None for an attention-free model, views of the
    slot's SSM state (leaves (L, ...)) or None, the slot's length).  A
    consumer that keeps the SSM state copies it (``disagg.ssm_host``); a
    spill never reads it."""
    length = int(state.lengths[slot])
    ssm_slot = None
    if state.ssm is not None:
        ssm_slot = SSMState(*(t[:, slot] for t in state.ssm))
    wire = None if state.kv is None else cache_mod.export_sequence(
        state.kv, slot, n_cols, length, col0, tp, ti)
    return wire, ssm_slot, length


def restore_ssm(state: PagedState, slot: int, ssm_slot: SSMState
                ) -> PagedState:
    """Scatter one slot's SSM state (leaves (L, ...), any device) into
    ``slot``: a boundary snapshot hit whose pages were all mapped."""
    for dst, src in zip(state.ssm, ssm_slot):
        dst[:, slot].copy_(src)
    return state


def import_slot(state: PagedState, slot: int,
                kv_wire: Optional[cache_mod.PageWire], length: int,
                col0: int = 0, ssm_slot: Optional[SSMState] = None,
                tp: int = 1, ti: int = 0) -> PagedState:
    """Import an exported sequence into free slot ``slot``: pages from
    this pool's free list, fields byte-copied (``cache.import_sequence``;
    ``col0`` > 0 keeps the row below it; none for an attention-free
    model, ``kv_wire`` None), a hybrid's or an SSM model's ``ssm_slot``
    scattered into the slot, the slot active at ``length``."""
    if kv_wire is not None:
        cache_mod.import_sequence(state.kv, slot, kv_wire, length, col0, tp,
                                  ti)
    if ssm_slot is not None:
        restore_ssm(state, slot, ssm_slot)
    state.lengths[slot] = length
    state.active[slot] = True
    return state


def release_slots(state: PagedState, mask: np.ndarray,
                  free_mask: Optional[np.ndarray] = None) -> PagedState:
    """Evict finished sequences: free their pages (with prefix sharing,
    only ``free_mask``'s: the pages whose last reference went; none for
    an attention-free model), clear their slots."""
    if state.kv is not None:
        cache_mod.release_pages(state.kv, mask, free_mask)
    state.lengths[mask] = 0
    state.active[mask] = False
    return state
