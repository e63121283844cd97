"""Reference-side helpers of the tp = 2 port tests of the SSM, MoE,
encoder-decoder and VLM families (``test_torch_tp_{hybrid,moe,encdec,
ssm_only}.py``): the reference's fixed loop at tp under ``shmap``,
teacher-forced or greedy, with a VLM's or an encoder-decoder's stub
inputs, and the stream rule the port is held to."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.configs.base import MeshConfig
from repro.core import collectives as jcl
from repro.models import lm as jlm, params as JPM
from repro.serve import engine as jengine
from torch_port_util import to_np


def tree_np(t):
    """A torch tree as numpy (bf16 as ml_dtypes bf16, the same bits)."""
    if isinstance(t, dict):
        return {k: tree_np(v) for k, v in t.items()}
    return to_np(t)


def pair(a):
    """numpy -> what ``tp_jobs.to_tensor`` takes (bf16 as its bits)."""
    a = np.asarray(a)
    return ("bf16", a.view(np.uint16)) if a.dtype == ml_dtypes.bfloat16 \
        else a


def _loop(jcfg, jrun, tp, prompts, max_len, feed, n, extras=()):
    """The reference's prefill + ``n`` decode steps under shmap at ``tp``,
    fed ``feed`` (B, n) or, with None, its own greedy tokens: a jitted
    function of (params, prompts, the stub inputs named ``extras`` (a
    dict, replicated)[, feed]) -> (tokens (B, n + 1), the whole-vocab
    logits (n + 1, B, V))."""
    mesh_ = jax.make_mesh((1, tp), ("data", "model"))
    table = jlm.lm_table(jcfg, MeshConfig(data=1, model=tp, pod=1), jrun)
    dims = jlm.lm_fsdp_dims(table)

    def loop(pp, toks, ex, fd=None):
        lg, st = jengine.prefill(jcfg, jrun, pp, dims, toks, max_len, tp,
                                 **ex)
        tok = jengine.greedy_token(jcfg, lg, tp)
        outs, lgs = [tok], [lg]
        for t in range(n):
            lg, st = jengine.decode_step(
                jcfg, jrun, pp, dims, st,
                tok if fd is None else fd[:, t:t + 1], tp)
            tok = jengine.greedy_token(jcfg, lg, tp)
            outs.append(tok)
            lgs.append(lg)
        return jnp.concatenate(outs, 1), jnp.stack(lgs)[:, :, 0]

    ins = (JPM.param_pspecs(table), P(None, None),
           {k: P() for k in extras}) \
        + ((P(None, None),) if feed is not None else ())
    return jax.jit(jcl.shmap(loop, mesh_, ins,
                             (P(None, None), P(None, None, "model"))))


def ref_fixed(jcfg, jrun, tp, params, prompts, n, max_len, feed=None,
              extras=None):
    """The reference's fixed loop at ``tp`` from the whole tree ``params``
    (numpy), with the stub inputs ``extras`` (``front_embeds`` /
    ``enc_embeds``, numpy): (its greedy tokens (B, n + 1), the whole-vocab
    logits (n + 1, B, V) of the loop, fed ``feed`` (B, n) where given)."""
    extras = extras or {}
    f = _loop(jcfg, jrun, tp, prompts, max_len, feed, n, tuple(extras))
    args = (jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(prompts),
            {k: jnp.asarray(v) for k, v in extras.items()})
    if feed is not None:
        args += (jnp.asarray(feed),)
    toks, logits = f(*args)
    return np.asarray(toks), np.asarray(logits)


def ref_forced(jcfg, jrun, tp, params, prompt, stream, blk: int):
    """The reference's fixed loop teacher-forced as its scheduler admits
    ``prompt`` at ``tp``: the prompt's trunk of a multiple of tp
    prefilled, its tail and ``stream[:-1]`` fed.  Returns the whole-vocab
    logits (len(stream), V) that predict each stream position."""
    trunk = len(prompt) // tp * tp
    feed = np.concatenate([prompt[trunk:],
                           np.asarray(stream[:-1], np.int32)])[None]
    _, logits = ref_fixed(jcfg, jrun, tp, params, prompt[None, :trunk],
                          feed.shape[1], len(prompt) + len(stream) + blk * tp,
                          feed=feed)
    return logits[len(prompt) - trunk:, 0]


def first_replay(mix, tp: int) -> int:
    """The first request of ``mix`` whose prompt's tail replays at tp."""
    return next(i for i, r in enumerate(mix) if len(r["prompt"]) % tp)


def part_at_near_ties(jcfg, jrun, tp, params, mix, got, want, forced,
                      replay, blk: int) -> int:
    """Streams ``got`` against the reference's ``want`` (lists of (tokens,
    stop reason)) on requests ``mix``: equal, except that a request may
    part from the reference at a near-tie -- where the reference's top-2
    margin there, teacher-forced with its own stream (``ref_forced``), is
    within 1e-2 (twice the 5e-3 bound on the two packages' logits;
    ``ROADMAP.md`` section 3, item 2).  ``forced`` holds the port's
    logits, each request teacher-forced with its own stream through its
    paged path (the same trunk, tail replay and feed; ``tp_jobs.serve``'s
    ``forced``): on each request that parts they are within 5e-3 of the
    reference's up to the parting position, and, where ``replay`` (the
    reference's ``ref_forced`` logits of request ``first_replay(mix,
    tp)``) is given, on that request over its whole stream when it does
    not part.  Returns how many requests parted."""
    parted = 0
    v = jcfg.vocab_size
    for i, ((g, gw), (w, ww), req) in enumerate(zip(got, want, mix)):
        g = list(g)
        if (g, gw) == (w, ww):
            if replay is not None and i == first_replay(mix, tp):
                np.testing.assert_allclose(forced[i][:, :v], replay[:, :v],
                                           atol=5e-3, err_msg=str(i))
            continue
        j = next(k for k, (a, b) in enumerate(zip(g, w)) if a != b)
        logits = ref_forced(jcfg, jrun, tp, params, req["prompt"], w[:j + 1],
                            blk)
        np.testing.assert_allclose(forced[i][:j + 1, :v], logits[:, :v],
                                   atol=5e-3, err_msg=str((req["uid"], j)))
        top2 = np.sort(logits[j, :v])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin <= 1e-2, (req["uid"], j, g, w, margin)
        parted += 1
    return parted
