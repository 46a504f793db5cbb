"""The VLM family in the port (paligemma-3b reduced: 4 query heads over
ONE KV head, f32, CPU), against repro.

The forward with a patch prefix (`prefix_embeds`: prepended to the scaled
token embeddings, attended causally, sliced off the logits), `forward` and
`loss_fn` on a batch with `patches`, all against repro's at 1e-5 on
repro's weights (through the bridge); remat changes no value and no
gradient; #1's plain version at head dim 256 (paligemma-3b's) against
repro's oracle and its Pallas kernel in interpret mode; and the engine,
which serves a VLM as its text decoder (no image prefix on the serve path,
as in repro): at mesh (1, 2) the one KV head is replicated over both TP
ranks (kv_rep 2, the TP pool holds half the EP tokens), tp == ep ==
lm_forward argmax, a tp->ep switch equals the run that never switched,
and repro's engine in a 2-device subprocess gives the port's tokens
through the same switch (ROADMAP C3's margin rule).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.paged_attention.ops import paged_attention as j_attn
from repro.models import registry as jreg
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.core.layouts import get_layout, group_info
from repro_torch.core.policy import PolicyConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttr
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from repro_torch.training.optimizer import leaves, tree_map
from tests._torch_common import assert_greedy_agree, jax_params
from tests.helpers import run_multidevice

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)


@pytest.fixture(scope="module")
def vlm():
    jc = j_get_config("paligemma-3b").reduced(param_dtype=jnp.float32,
                                               compute_dtype=jnp.float32)
    tc = get_config("paligemma-3b").reduced()
    assert (tc.num_kv_heads, tc.num_heads, tc.head_dim, tc.num_patches) == \
        (jc.num_kv_heads, jc.num_heads, jc.head_dim, jc.num_patches) == \
        (1, 4, 16, 8)
    jp, tp = jax_params(jc, seed=2)
    return jc, tc, jp, tp


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)),
            "patches": rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("fn", ["lm_forward", "forward", "loss_fn"])
def test_vlm_with_patches_matches_repro(vlm, fn):
    jc, tc, jp, tp = vlm
    b = _batch(jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if fn == "lm_forward":
        want = jtr.lm_forward(jc, jp, jb["tokens"], remat=False,
                              prefix_embeds=jb["patches"])
        got = ttr.lm_forward(tc, tp, tb["tokens"], prefix_embeds=tb["patches"])
    else:
        want = getattr(jreg, fn)(jc, jp, jb)
        got = getattr(treg, fn)(tc, tp, tb)
    want = np.asarray(want)
    assert got.shape == want.shape
    if fn != "loss_fn":
        assert want.shape == (2, 12, jc.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the prefix matters: without it the logits move
    if fn == "lm_forward":
        bare = ttr.lm_forward(tc, tp, tb["tokens"])
        assert float((bare - got).abs().max()) > 1e-3


def test_vlm_remat_changes_no_value(vlm):
    _, tc, _, tp = vlm
    tb = {k: torch.from_numpy(v) for k, v in _batch(tc, seed=1).items()}
    out = {}
    for remat in (True, False):
        p = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        loss = treg.loss_fn(tc, p, tb, remat=remat)
        grads = torch.autograd.grad(loss, leaves(p))
        out[remat] = (float(loss.detach()), grads)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("H,Sq", [(8, 1), (4, 1), (8, 5)])
def test_paged_attention_plain_matches_repro_at_head_dim_256(H, Sq):
    """#1's plain version at paligemma-3b's head dim over one KV head
    (ep's 8 query heads, tp's 4 a rank, a prefill chunk) against repro's
    oracle and its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(H + Sq)
    B, K, dh, page, maxp, pages = 2, 1, 256, 4, 5, 12
    q = rng.standard_normal((B, Sq, H, dh), dtype=np.float32)
    kp = rng.standard_normal((pages, page, K, dh), dtype=np.float32)
    vp = rng.standard_normal((pages, page, K, dh), dtype=np.float32)
    bt = rng.integers(0, pages, (B, maxp)).astype(np.int32)
    q_off = np.array([3, 20 - Sq], np.int32)
    kv_lens = (q_off + Sq).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, kv_lens)]
    r = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=0, page_chunk=2,
               backend="ref")
    i = j_attn(*jargs, q_offset=jnp.asarray(q_off), window=0, page_chunk=2,
               backend="interpret")
    p = paged_attention(*[torch.from_numpy(a) for a in
                          (q, kp, vp, bt, kv_lens)],
                        q_offset=torch.from_numpy(q_off), window=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(i), **TOL)


# ---------------------------------------------------------------------------
# the engine: the text decoder, one KV head replicated over the TP ranks
# ---------------------------------------------------------------------------

def _reqs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        5, 200, int(rng.integers(3, 10)))],
        max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
        for i in range(n)]


def _serve(cfg, params, start, switches=(), **kw):
    eng = MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=params,
                        ecfg=EngineConfig(**dict(dict(
                            start_layout=start, ladder=(4, 8),
                            prefill_chunk=8, policy=STATIC, seed=0), **kw)),
                        device="cpu")
    for r in _reqs():
        eng.submit(r)
    todo = dict(switches)
    i = 0
    while eng.sched.has_work():
        if i in todo:
            assert eng.execute_switch(todo.pop(i))
        eng.step()
        i += 1
        assert i < 500
    eng.run()
    assert not todo
    return eng, {r.rid: list(r.output) for r in eng.finished}


def test_vlm_engine_replicates_kv_and_matches_lm_forward(vlm):
    """kv_rep 2 at G = 2 (the paper's capacity penalty: the TP view holds
    half the EP view's tokens); tp and ep serve lm_forward's greedy
    argmax; a tp->ep switch and an ep->tp one leave the tokens equal to
    the never-switched run."""
    _, tc, _, tp = vlm
    gi = group_info(tc, 2)
    assert (gi.kv_local, gi.kv_rep, gi.q_local) == (1, 2, 2)
    assert get_layout("tp").kv_capacity_tokens(tc, 2, 128) == 64
    assert get_layout("ep").kv_capacity_tokens(tc, 2, 128) == 128
    runs = {lo: _serve(tc, tp, lo)[1] for lo in ("tp", "ep")}
    assert runs["tp"] == runs["ep"]
    for r in _reqs():
        seq = list(r.prompt)
        for t in runs["tp"][r.rid]:
            lg = ttr.lm_forward(tc, tp, torch.tensor([seq]))[0, -1]
            assert t == int(lg.argmax())
            seq.append(t)
    for start, target in (("tp", "ep"), ("ep", "tp")):
        eng, out = _serve(tc, tp, start, {3: target})
        assert [s.direction for s in eng.switch_records] == \
            [f"{start}_to_{target}"]
        assert out == runs[start]


_REPRO_VLM = """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.policy import PolicyConfig
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.serving.engine import EngineConfig, MoebiusEngine
from repro.serving.kvcache import CacheConfig
from repro.serving.request import Request
cfg = get_config("paligemma-3b").reduced(param_dtype=jnp.float32,
                                         compute_dtype=jnp.float32)
eng = MoebiusEngine(cfg, make_mesh((1, 2), ("data", "model")),
                    CacheConfig(**{cc}),
                    params_global=init_params(cfg, jax.random.PRNGKey(2)),
                    ecfg=EngineConfig(ladder=(4, 8), prefill_chunk=8,
                                      policy=PolicyConfig(
                                          t_high=10**9, t_low=-1,
                                          cooldown_s=10**9)))
for r in {reqs}:
    eng.submit(Request(rid=r[0], prompt=r[1], max_new_tokens=r[2],
                       arrival_s=0.0))
i = 0
while eng.pending or eng.waiting or eng.prefilling or eng.running:
    if i == 3:
        eng.execute_switch("ep")
    eng.step()
    i += 1
print(json.dumps({{"out": {{r.rid: list(map(int, r.output))
                          for r in eng.finished}},
                  "switches": [s.direction for s in eng.switch_records]}}))
"""


def test_vlm_engine_matches_repro_engine(vlm):
    """repro's engine and the port's on reduced paligemma-3b at mesh
    (1, 2) (kv_rep 2 in tp), repro's default EngineConfig, a tp->ep switch
    at iteration 3, repro's weights on both sides."""
    jc, tc, jp, tp = vlm
    reqs = [(r.rid, r.prompt, r.max_new_tokens) for r in _reqs()]
    ref = json.loads(run_multidevice(_REPRO_VLM.format(cc=CC, reqs=reqs),
                                     devices=2).strip().splitlines()[-1])
    eng, got = _serve(tc, tp, "tp", {3: "ep"}, prefix_cache=True)
    want = {int(k): v for k, v in ref["out"].items()}
    prompts = {r.rid: r.prompt for r in _reqs()}
    assert_greedy_agree(jc, jp, prompts, got, want)
    assert [r.direction for r in eng.switch_records] == ref["switches"] \
        == ["tp_to_ep"]
