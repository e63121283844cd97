"""What the ranks of a spawned tensor-parallel group run
(``launch.mesh.spawn(fn, world, ...)`` calls ``fn(group, *args)`` on each
rank): serving through ``ServeEngine(tp=...)``, the fixed-batch loop, and
the compressed collectives on given inputs, each on weights or inputs
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
    """numpy -> torch; a ``("bf16", uint16 bits)`` pair -> bf16."""
    if isinstance(a, tuple) and a[0] == "bf16":
        return torch.from_numpy(np.ascontiguousarray(a[1])) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_numpy(t: torch.Tensor):
    """torch -> numpy; bf16 -> ``("bf16", uint16 bits)``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return ("bf16", t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


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


def serve(tg, cfg, run, requests: List[Dict[str, Any]],
          spec: Dict[str, Any]) -> Dict[str, Any]:
    """``ServeEngine(group=tg)`` on this rank: ``requests`` as dicts of
    ``Request`` fields (prompt numpy), ``spec`` the engine's keywords
    (``engine``: n_slots, max_len, seed, prefix_sharing, compress_weights,
    max_fuse_steps, ...), ``params`` (see ``_params_for``), ``device``,
    ``then`` (more request lists, served after it on the same engine) and
    ``packed_leaves`` (return the rank's packed fields).  Returns the
    streams (tokens, stop reasons) of each run, its stats and the wire
    bytes of its activation gathers."""
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
            stats=st.__dict__.copy(), wire=dict(cl.wire.__dict__)))
    res["pages_in_use"] = eng._pages_in_use()
    if spec.get("packed_leaves"):
        res["packed"] = _packed_leaves(eng.params)
    return res


def fixed(tg, cfg, run, prompts: np.ndarray, new_tokens: int, max_len: int,
          spec: Dict[str, Any]) -> Dict[str, Any]:
    """The fixed-batch loop at tp = world on this rank, on the whole tree
    ``spec["params"]`` cut to its shard: ``generate``'s tokens (B,
    new_tokens + 1), and, with ``spec["forced"]`` (B, new_tokens) tokens,
    the whole-vocab logits of the prefill and of each decode step fed
    them (teacher forcing: the ranks' vocab shards gathered)."""
    from repro_torch.serve import engine

    device = torch.device(spec.get("device", "cpu"))
    params = _params_for(tg, cfg, spec, device)
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    got = engine.generate(cfg, run, params, toks, new_tokens, max_len, tg)
    res = dict(tokens=got.cpu().numpy())
    forced: Optional[np.ndarray] = spec.get("forced")
    if forced is not None:
        whole = lambda lg: cl.all_gather(lg[:, 0], tg, axis=-1)
        lg, st = engine.prefill(cfg, run, params, toks, max_len, tg)
        out = [whole(lg).cpu().numpy()]
        for t in range(forced.shape[1]):
            step = torch.as_tensor(forced[:, t:t + 1], dtype=torch.int32,
                                   device=device)
            out.append(whole(engine.decode_step(cfg, run, params, st, step,
                                                tg)).cpu().numpy())
        res["logits"] = np.stack(out)
    return res
