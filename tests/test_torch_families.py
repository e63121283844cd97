"""Every configuration at tp = 1, and gemma2 on the continuous path.

- ``lm.lm_table`` builds for every name in ``repro_torch.configs`` (no
  family is refused at tp = 1), with the reference's leaves and shapes;
- reduced gemma2-9b (alternating 16-token windows, softcaps, sandwich
  norms) on ``ServeEngine``, weights bridged from the reference: the
  reference ``ServeEngine``'s greedy streams, compared for identity."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import make_reduced as jmake_reduced
from repro.configs.base import MeshConfig, RunConfig as JRun
from repro.core.collectives import CodecConfig as JCodec
from repro.models import lm as jlm, params as jparams
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import _MODULES, get_config, make_reduced
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.collectives import CodecConfig as TCodec
from repro_torch.models import lm as tlm, params as tparams
from repro_torch.models.params import from_jax_params
from repro_torch.serve.scheduler import Request, ServeEngine

torch.set_num_threads(2)


def _flat(t, path=""):
    if isinstance(t, tparams.PDef):
        return {path: (t.shape, t.init)}
    out = {}
    for k, v in t.items():
        out.update(_flat(v, f"{path}['{k}']"))
    return out


@pytest.mark.parametrize("name", list(_MODULES))
def test_every_config_builds_at_tp1(name):
    """The port's parameter table of every configuration at tp = 1 is
    the reference's, leaf for leaf (shape and init)."""
    table = tlm.lm_table(get_config(name))
    jt = jlm.lm_table(jget_config(name), MeshConfig(data=1, model=1, pod=1),
                      JRun())
    want = {jax.tree_util.keystr(k): (v.shape, v.init) for k, v in
            jax.tree_util.tree_flatten_with_path(
                jt, is_leaf=jparams.is_pdef)[0]}
    assert _flat(table) == want


def _mix(cls):
    """Prompts on both sides of the 16-token window, more requests than
    slots, decode crossing ring blocks."""
    rng = np.random.default_rng(4)
    specs = [(12, 6), (21, 8), (6, 10), (17, 5)]
    return [cls(uid=i, prompt=rng.integers(0, 1009, (s,)).astype(np.int32),
                max_new_tokens=n) for i, (s, n) in enumerate(specs)]


def test_gemma2_serve_engine_streams():
    """Reduced gemma2-9b (2 layers: a 16-token window on layer 0, softcap
    50 in attention and 30 on the logits, post norms, scaled embeddings,
    tied head) served by the port's ``ServeEngine`` (block 4, 2 slots,
    sharing off) from the reference engine's weights: the reference's
    streams and admission counts."""
    jcfg = jmake_reduced(jget_config("gemma2-9b"))
    tcfg = make_reduced(get_config("gemma2-9b"))
    assert tcfg.attn_layout == "alternating_local" and tcfg.window == 16
    je = JEngine(jcfg, JRun(codec=JCodec(cache_block=4)), tp=1, n_slots=2,
                 max_len=48, seed=3, prefix_sharing=False, max_fuse_steps=1)
    jres, jst = je.run(_mix(JRequest))
    te = ServeEngine(tcfg, TRun(codec=TCodec(cache_block=4)), n_slots=2,
                     max_len=48, params=from_jax_params(
                         jax.device_get(je.params)),
                     prefix_sharing=False, max_fuse_steps=1, device="cpu")
    res, st = te.run(_mix(Request))
    assert [(r.tokens, r.stop_reason) for r in res] \
        == [(r.tokens, r.stop_reason) for r in jres]
    assert st.n_admit_dispatches == jst.n_admit_dispatches
    assert st.n_replay_dispatches == jst.n_replay_dispatches > 0
    assert st.peak_pages == jst.peak_pages > 0
