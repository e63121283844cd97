"""What the ranks of a spawned group run (``launch.mesh.spawn(fn, world,
...)`` calls ``fn(group, *args)`` on each rank): serving through
``ServeEngine(tp=...)`` and the paged path teacher-forced, a
``DisaggEngine(group=)`` fleet and a decode replica fed wire blobs, the
fixed-batch loop (with a VLM's or an encoder-decoder's stub inputs), an
encoder's memory and cross-attention stores, one layer's SSM and MoE
functions, the compressed
collectives and their differentiable wrappers on given inputs, the fused
gradient sync, the vocab-sharded loss, and training steps on any data x
model mesh, each on weights or inputs
handed in, for a check against another implementation (the CPU tests
hold them against the JAX reference).  The module imports torch and the
port only, so a spawned rank never imports more.  (``launch/serve.py
--tp N`` and ``chip_smoke.py`` spawn their own rank functions.)

Every job takes plain picklable data (configs, numpy arrays, dicts) and
returns plain data; bf16 arrays travel as their uint16 bits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import collectives as cl


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy -> torch (a copy: a job may update it in place); a ``("bf16",
    uint16 bits)`` pair -> bf16."""
    if isinstance(a, tuple) and a[0] == "bf16":
        return torch.from_numpy(np.array(a[1], copy=True)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t: torch.Tensor):
    """torch -> numpy (a copy: the job may go on updating ``t`` in
    place); bf16 -> ``("bf16", uint16 bits)``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return ("bf16", t.view(torch.int16).numpy().view(np.uint16).copy())
    return t.numpy().copy()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def collectives(tg, cases: List[Dict[str, Any]],
                device: str = "cpu") -> List[Dict[str, Any]]:
    """Run each case's collective on this rank's input ``case["xs"][rank]``
    (bf16 pairs, see ``to_tensor``): ``op`` one of all_gather, psum,
    all_to_all, ppermute (compressed), psum_plain, psum_scatter, pmax,
    pmin; ``kw`` its keywords; ``codec`` a ``CodecConfig``.  Returns, per
    case, the output and the packed bytes this rank put on the wire
    (``collectives.wire.keep``: one array per compressed call)."""
    ops = {"all_gather": cl.compressed_all_gather,
           "psum": cl.compressed_psum, "all_to_all": cl.compressed_all_to_all,
           "ppermute": lambda x, tg, codec, perm: cl.compressed_ppermute(
               x, tg, perm, codec),
           "psum_plain": lambda x, tg, codec: cl.psum(x, tg),
           "psum_scatter": lambda x, tg, codec, axis: cl.psum_scatter(
               x, tg, axis),
           "pmax": lambda x, tg, codec: cl.pmax(x, tg),
           "pmin": lambda x, tg, codec: cl.pmin(x, tg)}
    out = []
    for case in cases:
        x = to_tensor(case["xs"][tg.rank], device)
        cl.wire.keep = []
        y = ops[case["op"]](x, tg, case.get("codec", cl.DEFAULT_CODEC),
                            **case["kw"])
        out.append(dict(y=to_numpy(y), wire=cl.wire.keep))
        cl.wire.keep = None
    return out


def batch(tg, calls: List[Any]) -> List[Any]:
    """Several jobs of this module on one spawn: ``calls`` a list of (job
    name, its arguments after the group); their results in order."""
    return [globals()[name](tg, *args) for name, args in calls]


# ---------------------------------------------------------------------------
# one layer's mixers
# ---------------------------------------------------------------------------

def mixers(tg, cfg, run, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Each case's layer function on this rank, its weights ``case["p"]``
    (one layer's whole ``ssm`` or ``moe`` subtree, numpy) cut to the
    rank's shard: ``fn`` one of ssm_forward (``x`` the gathered input),
    ssm_decode_step (``x`` and ``state[rank]``, the rank's state leaves),
    moe_forward (``x[rank]``, the rank's sequence shard; ``groups``) and
    moe_decode (``x``); bf16 inputs as pairs (``to_tensor``).  Returns,
    per case, the output, the new state (SSM) and the packed bytes this
    rank put on the wire (one array per compressed call)."""
    from repro_torch.models import moe, params as PM, ssm

    out = []
    for case in cases:
        fn = case["fn"]
        mod = ssm if fn.startswith("ssm") else moe
        table = (ssm.ssm_table(cfg, tg.world) if mod is ssm
                 else moe.moe_table(cfg, tg.world))
        p = PM.shard_params(case["p"], table, tg.world, tg.rank)
        x = case["x"]
        x = to_tensor(x[tg.rank] if fn == "moe_forward" else x)
        cl.wire.keep = []
        st = None
        if fn == "ssm_forward":
            y, st = ssm.ssm_forward(cfg, p, x, want_state=True, tg=tg)
        elif fn == "ssm_decode_step":
            state = ssm.SSMState(*(to_tensor(a)
                                   for a in case["state"][tg.rank]))
            y, st = ssm.ssm_decode_step(cfg, p, x, state, tg)
        elif fn == "moe_forward":
            y = moe.moe_forward(cfg, run, p, x, groups=case.get("groups", 1),
                                tg=tg)[0]
        else:
            y = moe.moe_decode(cfg, p, x, tg)
        out.append(dict(y=to_numpy(y), wire=cl.wire.keep,
                        state=None if st is None
                        else [to_numpy(t) for t in st]))
        cl.wire.keep = None
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _params_for(tg, cfg, spec: Dict[str, Any], device):
    """The rank's parameters: ``spec["params"]`` a whole tree of the tp
    table (numpy, e.g. the reference's) cut to this rank's shard, or None
    (the engine's seeded init)."""
    from repro_torch.models import lm, params as PM

    tree = spec.get("params")
    if tree is None:
        return None
    local = PM.shard_params(tree, lm.lm_table(cfg, tg.world), tg.world,
                            tg.rank)
    return PM.to_device(local, device)


def _packed_leaves(params) -> Dict[str, Dict[str, np.ndarray]]:
    """This rank's PackedWeight leaves' fields, by path."""
    from repro_torch.core.weights import PackedWeight

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, PackedWeight):
            out["/".join(path)] = dict(
                signman=t.signman.cpu().numpy(),
                planes=t.planes.cpu().numpy().view(np.uint32),
                dict_syms=t.dict_syms.cpu().numpy(), k=t.k)
    walk(params, ())
    return out


def paged_forced(tg, cfg, run, params, prompts: List[np.ndarray],
                 streams: List[List[int]], device) -> List[np.ndarray]:
    """The paged path teacher-forced as the scheduler admits each prompt
    at tp = world (``tg`` None: tp = 1): its trunk of a multiple of tp
    prefilled into a slot of its own, then its tail and
    ``streams[i][:-1]`` fed through paged decode steps, all slots in one
    step while they have tokens left (the others masked, as a replay
    window masks them).  Returns, per prompt, the whole-vocab logits
    (len(stream), Vp) that predict each stream position (the ranks'
    vocab shards gathered)."""
    from repro_torch.serve import engine

    tp = cl.world(tg)
    trunks = [len(p) // tp * tp for p in prompts]
    st = engine.empty_paged_state(
        cfg, run, len(prompts), max(len(p) + len(s) for p, s in
                                    zip(prompts, streams))
        + run.codec.cache_block * tp, device=device, tp=tp)
    rows, feeds = [], []
    for i, (prompt, trunk) in enumerate(zip(prompts, trunks)):
        lg, d = engine.prefill_sequences(cfg, run, params, torch.as_tensor(
            prompt[None, :trunk], dtype=torch.int32, device=device), tg)
        engine.insert_sequences(cfg, run, st, d, [i], tp)
        rows.append([lg[0, -1]])
        feeds.append([*prompt[trunk:], *streams[i][:-1]])
    dec = engine.PagedDecoder(cfg, run, st, graphs=False, tg=tg)
    for t in range(max(map(len, feeds))):
        act = np.asarray([t < len(f) for f in feeds])
        dec.tok.copy_(torch.as_tensor([[f[t] if t < len(f) else 0]
                                       for f in feeds], device=device))
        lg = dec.forward(params, act)
        for i in np.flatnonzero(act):
            rows[i].append(lg[i, -1])
    return [cl.all_gather(torch.stack(r[len(p) - trunk:]), tg,
                          axis=-1).float().cpu().numpy()
            for r, p, trunk in zip(rows, prompts, trunks)]


def serve(tg, cfg, run, requests: List[Dict[str, Any]],
          spec: Dict[str, Any]) -> Dict[str, Any]:
    """``ServeEngine(group=tg)`` on this rank: ``requests`` as dicts of
    ``Request`` fields (prompt numpy), ``spec`` the engine's keywords
    (``engine``: n_slots, max_len, seed, prefix_sharing, compress_weights,
    max_fuse_steps, ...), ``params`` (see ``_params_for``), ``device``,
    ``then`` (more request lists, served after it on the same engine),
    ``packed_leaves`` (return the rank's packed fields) and ``forced``
    (each request's own stream teacher-forced through the engine's
    weights, ``paged_forced``).  Returns the streams (tokens, stop
    reasons) of each run, its stats, the wire bytes of its activation
    gathers and, with ``forced``, each request's forced logits."""
    from repro_torch.serve.scheduler import Request, ServeEngine

    device = torch.device(spec.get("device", "cpu"))
    eng = ServeEngine(cfg, run, group=tg, device=device,
                      params=_params_for(tg, cfg, spec, device),
                      **spec.get("engine", {}))
    res = dict(runs=[])
    for reqs in [requests] + list(spec.get("then", ())):
        cl.wire.reset()
        results, st = eng.run([Request(**r) for r in reqs])
        res["runs"].append(dict(
            streams=[(list(r.tokens), r.stop_reason) for r in results],
            stats=st.__dict__.copy(), wire=cl.wire.snapshot()))
        if spec.get("forced"):
            res["runs"][-1]["forced"] = paged_forced(
                tg, cfg, eng.run_cfg, eng.params, [r["prompt"] for r in reqs],
                [list(o.tokens) for o in results], device)
    res["pages_in_use"] = eng._pages_in_use()
    if spec.get("packed_leaves"):
        res["packed"] = _packed_leaves(eng.params)
    return res


def disagg(tg, cfg, run, requests: List[Dict[str, Any]],
           spec: Dict[str, Any]) -> Dict[str, Any]:
    """A ``DisaggEngine(group=tg)`` fleet on this rank (its replicas in
    one process, a loopback transport): ``requests`` as in ``serve``,
    ``spec`` the fleet's keywords (``engine``: n_prefill, n_decode,
    n_slots, max_len, streaming, compress_weights, ...), ``params`` and
    ``device`` as in ``serve``, ``blobs`` (record each handoff's closing
    blob, serialized with no dedup, and its request, in export order)
    and ``mono`` (also serve the requests on a monolithic
    ``ServeEngine`` on the same weights).  Returns the streams, the
    fleet's stats (with ``link_reduction``), the recorded blobs and the
    monolithic streams."""
    from repro_torch.serve.disagg import DisaggEngine
    from repro_torch.serve.scheduler import Request, ServeEngine

    device = torch.device(spec.get("device", "cpu"))
    kw = dict(spec.get("engine", {}))
    eng = DisaggEngine(cfg, run, group=tg, device=device,
                       params=_params_for(tg, cfg, spec, device), **kw)
    blobs: List[Dict[str, Any]] = []
    if spec.get("blobs"):
        for pr in eng.prefills:
            def export(s, pr=pr, orig=pr._export_blob):
                blob, req = orig(s), pr.ls.slot_req[s]
                blobs.append(dict(req=dict(
                    uid=req.uid, prompt=np.asarray(req.prompt),
                    max_new_tokens=req.max_new_tokens),
                    wire=blob.to_wire()[0]))
                return blob
            pr._export_blob = export
    results, st = eng.run([Request(**r) for r in requests])
    res = dict(streams=[(list(r.tokens), r.stop_reason) for r in results],
               stats=dict(st.__dict__, link_reduction=st.link_reduction),
               blobs=blobs)
    if spec.get("mono"):
        mono = ServeEngine(cfg, run, group=tg, device=device,
                           params=eng.params,
                           n_slots=kw.get("n_slots", 4),
                           max_len=kw.get("max_len", 256),
                           max_fuse_steps=kw.get("max_fuse_steps", 32))
        out, _ = mono.run([Request(**r) for r in requests])
        res["mono"] = [(list(r.tokens), r.stop_reason) for r in out]
    return res


def decode_blobs(tg, cfg, run, handoffs: List[Dict[str, Any]],
                 spec: Dict[str, Any]) -> Dict[int, Any]:
    """A decode replica of ``ServeEngine(group=tg, **spec["engine"])`` fed
    wire blobs (another implementation's prefill replica's: ``handoffs``
    as dicts of ``req`` (``Request`` fields) and ``wire``, the closing
    blob's bytes), parsed by the port's ``SequenceBlob.from_wire``; each
    rank imports its shard as slots free and decodes to the end.  Returns
    each request's (tokens, stop reason) by uid."""
    from repro_torch.serve.disagg import DecodeReplica, Handoff
    from repro_torch.serve.scheduler import Request, ServeEngine
    from repro_torch.serve.transport import SequenceBlob

    device = torch.device(spec.get("device", "cpu"))
    dec = DecodeReplica(ServeEngine(
        cfg, run, group=tg, device=device,
        params=_params_for(tg, cfg, spec, device), **spec.get("engine", {})))
    pending = list(handoffs)
    out: Dict[int, Any] = {}
    while pending or not dec.idle():
        while pending and dec.free_slots():
            h = pending.pop(0)
            dec.import_handoff(Handoff(
                req=Request(**h["req"]), admit_t=0.0,
                blob=SequenceBlob.from_wire(h["wire"])))
        for r in dec.step_window():
            out[r.uid] = (list(r.tokens), r.stop_reason)
    return out


STUBS = ("front_embeds", "enc_embeds")


def _store_fields(store) -> Dict[str, np.ndarray]:
    """A batch-shared block store's fields (group = B: the reference's
    layout, the group axis dropped) and ring, as numpy bytes."""
    out = {f: getattr(store, f)[0].cpu().numpy() for f in
           ("signman", "dict_syms", "esc_pos", "esc_raw")
           if getattr(store, f) is not None}
    if store.planes is not None:
        out["planes"] = store.planes[0].cpu().numpy().view(np.uint32)
    out["ring"] = store.ring.view(torch.int16).cpu().numpy() \
        .view(np.uint16)
    return out


def fixed(tg, cfg, run, prompts: np.ndarray, new_tokens: int, max_len: int,
          spec: Dict[str, Any]) -> Dict[str, Any]:
    """The fixed-batch loop at tp = world on this rank, on the whole tree
    ``spec["params"]`` cut to its shard, with a VLM's or an
    encoder-decoder's stub inputs ``spec["front_embeds"]`` /
    ``spec["enc_embeds"]`` (the whole arrays, the same on every rank; bf16
    pairs): ``generate``'s tokens (B, new_tokens + 1) and the wire counts
    of its compressed collectives (``collectives.wire.snapshot``), and,
    with ``spec["forced"]`` (B, new_tokens) tokens, the whole-vocab logits
    of the prefill and of each decode step fed them (teacher forcing: the
    ranks' vocab shards gathered) and, for an encoder-decoder, the rank's
    cross-attention stores after that prefill (``xkv``: per layer, its
    fields as numpy)."""
    from repro_torch.serve import engine

    device = torch.device(spec.get("device", "cpu"))
    params = _params_for(tg, cfg, spec, device)
    extras = {k: to_tensor(spec[k], device) for k in STUBS if k in spec}
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    cl.wire.reset()
    got = engine.generate(cfg, run, params, toks, new_tokens, max_len, tg,
                          **extras)
    res = dict(tokens=got.cpu().numpy(), wire=cl.wire.snapshot())
    forced: Optional[np.ndarray] = spec.get("forced")
    if forced is not None:
        whole = lambda lg: cl.all_gather(lg[:, 0], tg, axis=-1)
        lg, st = engine.prefill(cfg, run, params, toks, max_len, tg,
                                **extras)
        if st.xkv is not None:
            res["xkv"] = [_store_fields(x) for x in st.xkv]
        out = [whole(lg).cpu().numpy()]
        for t in range(forced.shape[1]):
            step = torch.as_tensor(forced[:, t:t + 1], dtype=torch.int32,
                                   device=device)
            out.append(whole(engine.decode_step(cfg, run, params, st, step,
                                                tg)).cpu().numpy())
        res["logits"] = np.stack(out)
    return res


def encoder(tg, cfg, run, enc_embeds, kvs, max_len: int,
            spec: Dict[str, Any]) -> Dict[str, Any]:
    """An encoder-decoder's encoder at tp = world on this rank
    (``lm.encode`` of the whole ``enc_embeds``, bf16 pairs): the memory
    every rank gets and the packed bytes this rank put on the wire in the
    memory's gather (its last compressed call); then every decoder
    layer's cross-attention store filled as ``engine.prefill`` fills it
    (``engine.cache_payload``: the interleaving) from the given K/V
    ``kvs[rank][layer]`` (another implementation's (k, v) of the memory,
    (B, Hkv, Sm, hd) bf16 pairs: the rank's kv heads in ``col`` mode, every
    kv head in ``row`` mode), with room for ``max_len`` tokens (``xkv`` as
    ``fixed`` returns it)."""
    from repro_torch.models import cache as cache_mod, lm
    from repro_torch.serve import engine

    device = torch.device(spec.get("device", "cpu"))
    params = _params_for(tg, cfg, spec, device)
    cl.wire.keep = []
    mem = lm.encode(cfg, run, params, to_tensor(enc_embeds, device), tg)
    keep, cl.wire.keep = cl.wire.keep, None
    xkv = []
    for k, v in kvs[tg.rank]:
        k, v = to_tensor(k, device), to_tensor(v, device)
        store = cache_mod.empty_kv(cfg, run, k.shape[0], max_len,
                                   group=k.shape[0], device=device,
                                   tp=tg.world)
        cache_mod.fill_from_prefill(cfg, run, store,
                                    engine.cache_payload(cfg, (k, v), tg))
        xkv.append(_store_fields(store))
    return dict(memory=to_numpy(mem), wire=keep[-1] if keep else None,
                xkv=xkv)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def lexi_grads(tg, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Each case's differentiable collective (``op``: all_gather, psum,
    all_to_all, ppermute; ``kw`` its keywords) on this rank's input
    ``xs[rank]``, and the gradient of sum(y * ws[rank]) (f32) with
    respect to the input: the output and the gradient per case."""
    fns = {"all_gather": cl.lexi_all_gather, "psum": cl.lexi_psum,
           "all_to_all": cl.lexi_all_to_all,
           "ppermute": lambda x, tg, codec, perm: cl.lexi_ppermute(
               x, tg, perm, codec)}
    out = []
    for case in cases:
        x = to_tensor(case["xs"][tg.rank]).requires_grad_()
        w = to_tensor(case["ws"][tg.rank])
        y = fns[case["op"]](x, tg, case.get("codec", cl.DEFAULT_CODEC),
                            **case["kw"])
        (y.float() * w.float()).sum().backward()
        out.append(dict(y=to_numpy(y), g=to_numpy(x.grad)))
    return out


def sync_gradients(tg, trees: List[Dict[str, Any]],
                   codec) -> Dict[str, Any]:
    """``collectives.sync_gradients`` of this rank's tree ``trees[rank]``
    (a flat dict of arrays): the synced tree and the packed bytes this
    rank put on the wire."""
    grads = {k: to_tensor(v) for k, v in trees[tg.rank].items()}
    cl.wire.keep = []
    got = cl.sync_gradients(grads, tg, codec)
    wire, cl.wire.keep = cl.wire.keep, None
    return dict(out={k: to_numpy(v) for k, v in got.items()}, wire=wire)


def train_steps(tg, cfg, run, mesh_cfg, leaves: List[Any],
                batches: List[Dict[str, np.ndarray]],
                want: tuple = ()) -> Dict[str, Any]:
    """Training steps at ``mesh_cfg`` (any data x model mesh of world
    ranks; ``tg`` None at 1 x 1) on the CPU from a whole (logical) state
    (``leaves``: a ``TrainState``'s leaves in JAX's order, see
    ``to_tensor``), one step per global batch of ``batches``: each step's
    metrics, step 0's synced gradients (whole leaves, in order) and the
    compressed collectives' wire counts per step (by kind too).  ``want``
    may add "hidden": step 0's final-normed hidden state before the step,
    gathered over model (the data rank's batch slice, the whole
    sequence); "state": the whole state after step 0 (``full_state``)."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import state_like
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as TS

    mesh = mesh_mod.make_mesh(mesh_cfg, tg)
    table = lm.lm_table(cfg, tp=mesh.model, data=mesh.data, run=run)
    state = TS.shard_state(tree.unflatten(
        state_like(table), [to_tensor(a) for a in leaves]), table, mesh)
    step_fn = TS.make_train_step(cfg, run, mesh, table,
                                 total_steps=len(batches))
    res: Dict[str, Any] = dict(metrics=[], wire=[])
    synced = []
    plain_sync = opt_mod.sync_grads

    def keep_sync(*a, **kw):
        out = plain_sync(*a, **kw)
        synced.append(out)
        return out
    opt_mod.sync_grads = keep_sync
    try:
        for i, b in enumerate(batches):
            batch = shard_batch({k: to_tensor(v) for k, v in b.items()},
                                mesh.data_rank, mesh.data)
            if i == 0 and "hidden" in want:
                with torch.no_grad():
                    h = lm.train_forward(cfg, run, state.params,
                                         batch["tokens"], mesh,
                                         lm.lm_fsdp_dims(table))
                res["hidden"] = to_numpy(cl.all_gather(
                    h, mesh.axis_group(("model",)), 1))
            cl.wire.reset()
            state, metrics = step_fn(state, batch)
            res["metrics"].append({k: float(v) for k, v in metrics.items()})
            res["wire"].append(cl.wire.snapshot())
            if i == 0:
                res["grads"] = [to_numpy(g) for g in tree.leaves(
                    TS.full_tree(synced[0], table, mesh))]
                if "state" in want:
                    res["state"] = [to_numpy(x) for x in tree.leaves(
                        TS.full_state(state, table, mesh))]
    finally:
        opt_mod.sync_grads = plain_sync
    for w in res["wire"]:
        w.pop("keep", None)
    return res


def xent(tg, cfg, run, x, head, labels) -> Dict[str, Any]:
    """``models.lm.chunked_xent`` of this rank's shards (its contiguous
    sequence shard of ``x`` (B, S, D), its vocab shard of ``head`` (D,
    Vp); bf16 pairs) with the whole ``labels`` (B, S): the rank's loss sum
    and its gradient with respect to both shards."""
    from repro_torch.models import lm

    n, r = cl.world(tg), cl.rank(tg)
    xs = to_tensor(x).chunk(n, dim=1)[r].clone().requires_grad_()
    hs = to_tensor(head).chunk(n, dim=1)[r].clone().requires_grad_()
    loss = lm.chunked_xent(cfg, run, xs, hs, to_tensor(labels), tg)
    loss.backward()
    return dict(loss=float(loss.detach()), gx=to_numpy(xs.grad),
                ghead=to_numpy(hs.grad))


def fsdp_gather(tg, trees: List[Dict[str, Any]], codec) -> Dict[str, Any]:
    """``core.weights``' compressed store on this rank's dim-0 shards
    ``trees[rank]`` (a flat dict of arrays): ``compress_params``, its
    ``stored_bytes`` and ``param_bytes``, ``decompress_params``, and
    ``fsdp_gather_params`` over the group."""
    from repro_torch.core import weights as W

    local = {k: to_tensor(v) for k, v in trees[tg.rank].items()}
    cp = W.compress_params(local, codec)
    return dict(
        gathered={k: to_numpy(v) for k, v in
                  W.fsdp_gather_params(cp, tg).items()},
        back={k: to_numpy(v) for k, v in W.decompress_params(cp).items()},
        stored=W.stored_bytes(cp), raw=W.param_bytes(local))
