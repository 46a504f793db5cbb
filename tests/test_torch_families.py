"""The SSM, hybrid and encoder-decoder families of the port against repro's
(f32, CPU, reduced configs).

For mamba2-780m, zamba2-2.7b and whisper-base, each `reduced()`: the
port's `init_params` tree (shapes, dtypes) against repro's; the family's
forward (`ssm_lm_forward`, `hybrid_forward`, `encdec_forward`) against
repro's on repro's weights (carried by `repro_torch.bridge`); and the
serve step of serving/steps_extra.py at mesh (Dd, G) = (2, 4) in tp and
ep, driven greedily over 8 requests: its tokens equal repro's forward
greedy wherever repro's top-2 margin is clear (ROADMAP C3), tp and ep give
the same tokens, and the paged K/V of the hybrid's attention sites and the
decoder's self-attention equal repro's on the request pages (page 0, the
null page, left out: C5). The encoder-decoder step's prefill chunks
(Sq = 4, mixed with decode rows) equal token-by-token prefill, and the
step computes repro's `encdec_forward`, whose decoder has no RoPE, not a
RoPE'd decoder (ROADMAP C20). repro's forwards run in-process.

Tolerances: logits 1e-4 (relative and absolute; the f32 gap between two
frameworks' matmuls is up to 7.6e-5, C3), K/V 1e-4, the greedy margin
1e-4; tokens across layouts and chunkings exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import registry as jreg
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.layouts import get_layout, group_info, pack_params
from repro_torch.models import registry as treg
from repro_torch.serving import steps_extra as sx
from repro_torch.serving.kvcache import CacheConfig

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-4
NAMES = ["mamba2-780m", "zamba2-2.7b", "whisper-base"]
MESH = (2, 4)                   # (Dd, G)
BSLOT = 4
N_NEW = 5
CC = CacheConfig(page_size=4, pages_ep=16, max_pages_per_req=4)
PER = 3                         # pages a request uses (<= 11 positions)


def _cfgs(name):
    return (j_get_config(name).reduced(param_dtype=jnp.float32,
                                       compute_dtype=jnp.float32),
            get_config(name).reduced())


@pytest.fixture(scope="module")
def models():
    """name -> (jcfg, tcfg, repro params, the same as torch, frames)."""
    out = {}
    for name in NAMES:
        jc, tc = _cfgs(name)
        jp = jreg.init_params(jc, jax.random.PRNGKey(1))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        frames = None
        if tc.family == "encdec":
            frames = np.random.default_rng(2).standard_normal(
                (MESH[0] * BSLOT, tc.encoder_seq, tc.d_model)).astype(
                    np.float32)
        out[name] = (jc, tc, jp, tp, frames)
    return out


def _prompts(cfg):
    rng = np.random.default_rng(3)
    n = MESH[0] * BSLOT
    return [list(rng.integers(1, cfg.vocab_size, int(rng.choice([4, 6]))))
            for _ in range(n)]


def _check_greedy(jc, jp, prompts, outs, frames=None) -> list:
    """Each served token is repro's forward argmax along its own stream
    wherever repro's top-2 margin there is clear of MARGIN (ROADMAP C3);
    a stream is compared up to its first position that is not (past it
    the two may part). Equal-length streams share one forward. Returns
    the indices of the streams clear at every position."""
    clear = []
    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append(i)
    for n, idx in by_len.items():
        batch = {"tokens": jnp.asarray([list(prompts[i]) + outs[i][:-1]
                                        for i in idx])}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames[idx])
        lg = np.asarray(jreg.forward(jc, jp, batch, remat=False))[:, n - 1:]
        for b, i in enumerate(idx):
            top2 = np.sort(lg[b], axis=-1)[:, -2:]
            ok = True
            for k, t in enumerate(outs[i]):
                if top2[k, 1] - top2[k, 0] <= MARGIN:
                    ok = False
                    break
                assert t == int(np.argmax(lg[b, k])), (i, k, outs[i])
            if ok:
                clear.append(i)
    return clear


def _block_tables(layout, G):
    """(Dd, Bslot, maxp): PER pages a slot from page 1 up (page 0 is the
    null page), in its rank's own pool under ep, in the group's pool
    under tp."""
    Dd, maxp = MESH[0], CC.max_pages_per_req
    bs = BSLOT if get_layout(layout).base == "tp" else BSLOT // G
    bt = np.zeros((Dd, BSLOT, maxp), np.int32)
    for j in range(BSLOT):
        bt[:, j, :PER] = 1 + (j % bs) * PER + np.arange(PER)
    return bt


def _serve(tc, tp_params, frames, layout, prompts, Sq=1,
           return_logits=False):
    """Greedy serve of `prompts` (Dd * Bslot of them, slot j of group d =
    prompt d * Bslot + j) through the family's step: each prompt fed in
    chunks of Sq (one token a dispatch for the recurrent families), then
    its own samples one a dispatch; a finished slot goes dead (valid 0).
    Returns (outputs per prompt, kv_flat or None, logits per dispatch)."""
    Dd, G = MESH
    pk = pack_params(tc, tp_params, layout, G)
    key = None
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    kv = st = xkv = None
    fam = tc.family
    if fam != "ssm":
        kv = torch.zeros((Dd, G, CC.nelems(tc, G)))
    if fam in ("ssm", "hybrid"):
        st = sx.ssm_states(tc, Dd, BSLOT, device="cpu")
    if fam == "ssm":
        pack = sx.ssm_decode_pack(tc, pk, layout, G)
        step = sx.build_ssm_serve_step(tc, MESH, layout, BSLOT,
                                       return_logits=return_logits,
                                       device="cpu")
    elif fam == "hybrid":
        pack = sx.hybrid_decode_pack(tc, pk, layout, G)
        step = sx.build_hybrid_serve_step(tc, MESH, layout, CC, BSLOT,
                                          return_logits=return_logits,
                                          device="cpu")
    else:
        pack = sx.encdec_decode_pack(tc, pk, layout, G)
        step = sx.build_encdec_serve_step(tc, MESH, layout, CC, BSLOT,
                                          tc.encoder_seq, Sq,
                                          return_logits=return_logits,
                                          device="cpu")
        xkv = sx.encdec_cross_cache(tc, tp_params, T(frames), layout, G)
        xkv = xkv.reshape(Dd, BSLOT, *xkv.shape[1:])
    bt = T(_block_tables(layout, G))
    n = Dd * BSLOT
    pos = [0] * n
    outs = [[] for _ in range(n)]
    logs = []
    while any(len(o) < N_NEW for o in outs):
        tok = np.zeros((Dd, BSLOT, Sq), np.int32)
        p = np.zeros((Dd, BSLOT), np.int32)
        vl = np.zeros((Dd, BSLOT), np.int32)
        for i in range(n):
            d, j = divmod(i, BSLOT)
            if len(outs[i]) >= N_NEW:
                continue
            seq = list(prompts[i]) + outs[i]
            c = seq[pos[i]:pos[i] + Sq]
            tok[d, j, :len(c)] = c
            p[d, j], vl[d, j] = pos[i], len(c)
        if fam == "ssm":
            res = step(pack, st["conv_x"], st["conv_B"], st["conv_C"],
                       st["ssm"], T(tok), T(vl), key)
        elif fam == "hybrid":
            res = step(pack, kv, st["conv_x"], st["conv_B"], st["conv_C"],
                       st["ssm"], T(tok), T(p), T(vl), bt, key)
        else:
            res = step(pack, kv, xkv, T(tok), T(p), T(vl), bt, key)
        nxt = res[0].numpy()
        if return_logits:
            logs.append((p.copy(), vl.copy(), res[-1].numpy()))
        for i in range(n):
            d, j = divmod(i, BSLOT)
            if vl[d, j] == 0:
                continue
            pos[i] += int(vl[d, j])
            if pos[i] >= len(prompts[i]):
                outs[i].append(int(nxt[d, j]))
    return outs, kv, logs


def _slot_kv(tc, kv, layout, G, d, j, S):
    """K/V of slot j of group d at positions [0, S) from the flat pool:
    (Lk, 2, S, K, dh), each KV head read from the first rank holding it
    (ep: the slot's rank)."""
    spec = get_layout(layout)
    view = CC.view_shape(tc, G, spec)
    pool = kv[d].view(G, *view)
    bt = torch.from_numpy(_block_tables(layout, G)[d, j, :PER]).long()
    if spec.kv_per_rank:
        r = j // (BSLOT // G)
        got = pool[r][:, :, bt]
        return got.reshape(*got.shape[:2], -1, *got.shape[-2:])[:, :, :S]
    gi = group_info(tc, G)
    heads = []
    for h in range(tc.num_kv_heads):
        r = (h // gi.kv_local) * gi.kv_rep
        got = pool[r][:, :, bt, :, h - gi.kv_block(r)]
        heads.append(got.reshape(*got.shape[:2], -1, got.shape[-1])[:, :, :S])
    return torch.stack(heads, dim=3)


def _repro_kv(jc, jp, toks, frames=None):
    """repro's K/V of every attention site over `toks`: (Lk, 2, S, K, dh),
    from its own blocks (the hybrid's shared_block, the decoder's
    decoder_block) with return_kv."""
    from repro.models.common import apply_norm
    x = jp["embed"][jnp.asarray([toks])]
    out = []
    if jc.family == "hybrid":
        from repro.models.hybrid import shared_block
        from repro.models.ssm import ssm_forward
        k = jc.attn_every
        for g in range(jc.num_layers // k):
            for li in range(g * k, (g + 1) * k):
                lp = jax.tree.map(lambda a: a[li], jp["ssm_layers"])
                y, _ = ssm_forward(jc, lp["ssm"],
                                   apply_norm(jc, x, lp["norm"]))
                x = x + y
            x, (kk, vv) = shared_block(jc, jp["shared_attn"], x,
                                       return_kv=True)
            out.append(np.stack([kk[0], vv[0]]))
        return np.stack(out)
    from repro.models.encdec import cross_kv, decoder_block, encode
    enc = encode(jc, jp, jnp.asarray(frames[None]))
    x = x + jp["dec_pos"][:len(toks)][None]
    for li in range(jc.num_layers):
        lp = jax.tree.map(lambda a: a[li], jp["decoder"])
        x, (kk, vv) = decoder_block(jc, lp, x, cross_kv(jc, lp["xattn"], enc),
                                    return_kv=True)
        out.append(np.stack([kk[0], vv[0]]))
    return np.stack(out)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_repro(models, name):
    jc, tc, jp, _, _ = models[name]
    tp = treg.init_params(tc, 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    assert treg.count_params_actual(tp) == treg.count_params_analytic(tc) \
        == jreg.count_params_actual(jp)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_repro(models, name):
    jc, tc, jp, tp, frames = models[name]
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 11))
    batch_j = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        batch_j["frames"] = jnp.asarray(frames[:2])
        batch_t["frames"] = torch.from_numpy(frames[:2])
    want = np.asarray(jreg.forward(jc, jp, batch_j, remat=False))
    got = treg.forward(tc, tp, batch_t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_serve_step_matches_repro_greedy(models, name):
    """tp and ep at mesh (2, 4): repro's forward greedy where its margin
    is clear, tp == ep exactly, and the K/V on the request pages equal
    repro's (hybrid sites, decoder self-attention)."""
    jc, tc, jp, tp, frames = models[name]
    prompts = _prompts(tc)
    Sq = 4 if tc.family == "encdec" else 1
    runs, kvs = {}, {}
    for layout in ("tp", "ep"):
        runs[layout], kvs[layout], _ = _serve(tc, tp, frames, layout,
                                              prompts, Sq=Sq)
    assert runs["tp"] == runs["ep"]
    outs = runs["tp"]
    clear = _check_greedy(jc, jp, prompts, outs, frames)
    assert len(clear) >= len(prompts) // 2, clear
    if tc.family == "ssm":
        return
    for i in [c for c in clear if c in (0, 1, 5, 6)][:2]:
        d, j = divmod(i, BSLOT)
        seq = list(prompts[i]) + outs[i]
        S = len(seq) - 1
        want = _repro_kv(jc, jp, seq[:S],
                         None if frames is None else frames[i])
        for layout in ("tp", "ep"):
            got = _slot_kv(tc, kvs[layout], layout, MESH[1], d, j, S)
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encdec_chunked_prefill_matches_token_by_token(models):
    """whisper-base reduced: prefill chunks of 4 mixed with decode rows ==
    one token a dispatch (tokens exact, the K/V pool within 1e-5)."""
    _, tc, _, tp, frames = models["whisper-base"]
    prompts = _prompts(tc)
    for layout in ("tp", "ep"):
        o4, kv4, _ = _serve(tc, tp, frames, layout, prompts, Sq=4)
        o1, kv1, _ = _serve(tc, tp, frames, layout, prompts, Sq=1)
        assert o4 == o1
        for i in range(len(prompts)):
            d, j = divmod(i, BSLOT)
            S = len(prompts[i]) + N_NEW - 1
            torch.testing.assert_close(
                _slot_kv(tc, kv4, layout, MESH[1], d, j, S),
                _slot_kv(tc, kv1, layout, MESH[1], d, j, S),
                rtol=1e-5, atol=1e-5)


def _jax_encdec_logits(jc, jp, toks, frames, rope: bool):
    """repro's encdec_forward spelled out, with the decoder's RoPE a
    switch: rope=False is encdec_forward, rope=True what repro's step
    computes (C20)."""
    from repro.models.attention import attn_forward
    from repro.models.common import apply_norm
    from repro.models.encdec import cross_attend, cross_kv, encode
    from repro.models.mlp import mlp_forward
    enc = encode(jc, jp, jnp.asarray(frames[None]))
    x = jp["embed"][jnp.asarray([toks])] + jp["dec_pos"][:len(toks)][None]
    for li in range(jc.num_layers):
        lp = jax.tree.map(lambda a: a[li], jp["decoder"])
        h = apply_norm(jc, x, lp["attn_norm"])
        x = x + attn_forward(jc, lp["attn"], h, causal=True, rope=rope)
        h = apply_norm(jc, x, lp["xattn_norm"])
        x = x + cross_attend(jc, lp["xattn"], h,
                             *cross_kv(jc, lp["xattn"], enc))
        h = apply_norm(jc, x, lp["mlp_norm"])
        x = x + mlp_forward(jc, lp["mlp"], h)
    x = apply_norm(jc, x, jp["final_norm"])
    return np.asarray(x @ jp["embed"].T)[0]


def test_encdec_step_has_no_rope(models):
    """ROADMAP C20: the port's encdec step, teacher-forced one token a
    dispatch, gives encdec_forward's logits at every position, and not
    those of a decoder with RoPE (repro's step), which part from them
    past position 0 (RoPE at position 0 is the identity)."""
    jc, tc, jp, tp, frames = models["whisper-base"]
    prompts = _prompts(tc)
    _, _, logs = _serve(tc, tp, frames, "tp", prompts, Sq=1,
                        return_logits=True)
    i = 0                                    # slot 0 of group 0
    seq = list(prompts[i])
    fwd = np.asarray(jreg.forward(
        jc, jp, {"tokens": jnp.asarray([seq]),
                 "frames": jnp.asarray(frames[i:i + 1])}, remat=False))[0]
    no_rope = _jax_encdec_logits(jc, jp, seq, frames[i], rope=False)
    roped = _jax_encdec_logits(jc, jp, seq, frames[i], rope=True)
    np.testing.assert_allclose(no_rope, fwd, **TOL)
    V = tc.vocab_size
    got = np.stack([lg[0, 0, :V] for p, vl, lg in logs[:len(seq)]])
    assert [int(p[0, 0]) for p, _, _ in logs[:len(seq)]] == \
        list(range(len(seq)))
    np.testing.assert_allclose(got, fwd, **TOL)
    np.testing.assert_allclose(roped[0], fwd[0], **TOL)
    assert np.abs(got[1:] - roped[1:]).max() > 1e-2
