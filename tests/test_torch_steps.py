"""The port's serve step against repro (tiny_moe, f32, CPU).

The port's version of tests/test_multidevice.py:27-66: the mixed step
(prefill Sq=8, then 3 decode steps) under `tp` and `ep` at G in {1, 2, 4}
stacked ranks gives the greedy tokens of repro's `lm_forward` argmax on
the same params; at G=1 its logits match repro's own `build_mixed_step`
(return_logits) within 1e-4. Cross-framework f32 is not bitwise (ROADMAP
C3), so each greedy comparison first checks the logit margin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import pack_params as j_pack_params
from repro.launch.mesh import make_mesh
from repro.models.transformer import lm_forward
from repro.serving.kvcache import CacheConfig as JCacheConfig
from repro.serving.steps import build_decode_pack as j_build_decode_pack
from repro.serving.steps import build_mixed_step as j_build_mixed_step
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.core.layouts import pack_params
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.steps import build_decode_pack, build_mixed_step
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
PROMPT = [5, 9, 17, 3, 101, 42]
N_NEW = 4
CC = dict(page_size=4, pages_ep=16, max_pages_per_req=8)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    toks, margins = list(PROMPT), []
    for _ in range(N_NEW):
        lg = np.asarray(lm_forward(tiny_moe, jp, jnp.array([toks]),
                                   remat=False))[0, -1]
        top2 = np.sort(lg)[-2:]
        margins.append(float(top2[1] - top2[0]))
        toks.append(int(np.argmax(lg)))
    return tiny_moe, port_tiny_moe(), jp, tp, toks[len(PROMPT):], margins


def test_bridge_roundtrip_bit_exact(setup):
    jcfg, cfg, jp, tp, _, _ = setup
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # bf16 leaves cross bit-exactly (widened to f32 on the way back)
    b = jnp.asarray(np.linspace(-3, 3, 7, dtype=np.float32), jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(b)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"],
                                  np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("layout", ["tp", "ep", "tpep"])
def test_pack_params_matches_repro_bytes(setup, layout):
    jcfg, cfg, jp, tp, _, _ = setup
    G = 2
    ours = params_to_numpy(pack_params(cfg, tp, layout, G))
    ref = j_pack_params(jcfg, jp, layout, G)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = ours
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def _serve_prompt(cfg, tp, layout, G, return_logits=False):
    cc = CacheConfig(**CC)
    pack = build_decode_pack(cfg, pack_params(cfg, tp, layout, G), layout, G)
    kv = torch.zeros((1, G, cc.nelems(cfg, G)))
    B, P0 = 4, len(PROMPT)
    bt = np.zeros((1, B, 8), np.int32)
    bt[:, 0, :3] = [1, 2, 3]
    T = torch.from_numpy
    pre = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=8, device="cpu",
                           return_logits=return_logits)
    ti = np.zeros((1, B, 8), np.int32)
    ti[:, 0, :P0] = PROMPT
    vl = np.zeros((1, B), np.int32)
    vl[:, 0] = P0
    nxt, kv, *lg = pre(pack, kv, T(ti), T(np.zeros((1, B), np.int32)),
                       T(vl), T(bt))
    out, logits = [int(nxt[0, 0])], [lg[0][0, 0] if lg else None]
    dec = build_mixed_step(cfg, (1, G), layout, cc, B, Sq=1, device="cpu",
                           return_logits=return_logits)
    for i in range(N_NEW - 1):
        ti = np.zeros((1, B, 1), np.int32)
        ti[:, 0, 0] = out[-1]
        pos = np.zeros((1, B), np.int32)
        pos[:, 0] = P0 + i
        vl = np.zeros((1, B), np.int32)
        vl[:, 0] = 1
        nxt, kv, *lg = dec(pack, kv, T(ti), T(pos), T(vl), T(bt))
        out.append(int(nxt[0, 0]))
        logits.append(lg[0][0, 0] if lg else None)
    return out, logits


@pytest.mark.parametrize("layout", ["tp", "ep"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_step_tokens_match_lm_forward(setup, layout, G):
    jcfg, cfg, jp, tp, ref, margins = setup
    assert min(margins) > MARGIN, margins      # greedy tokens are decidable
    out, _ = _serve_prompt(cfg, tp, layout, G)
    assert out == ref, (layout, G, out, ref)


@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_step_logits_match_repro_step(setup, layout):
    jcfg, cfg, jp, tp, ref, _ = setup
    _, logits = _serve_prompt(cfg, tp, layout, 1, return_logits=True)
    mesh = make_mesh((1, 1), ("data", "model"))
    jcc = JCacheConfig(**CC)
    pack = j_build_decode_pack(jcfg, j_pack_params(jcfg, jp, layout, 1),
                               layout, 1)
    kv = jnp.zeros((1, 1, jcc.nelems(jcfg, 1)), jnp.float32)
    key = jax.random.key_data(jax.random.PRNGKey(1))
    B, P0 = 4, len(PROMPT)
    bt = np.zeros((1, B, 8), np.int32)
    bt[:, 0, :3] = [1, 2, 3]
    pre = j_build_mixed_step(jcfg, mesh, layout, jcc, B, Sq=8,
                             return_logits=True, donate=False)
    ti = np.zeros((1, B, 8), np.int32)
    ti[:, 0, :P0] = PROMPT
    vl = np.zeros((1, B), np.int32)
    vl[:, 0] = P0
    _, kv, lg = pre(pack, kv, jnp.asarray(ti), jnp.zeros((1, B), jnp.int32),
                    jnp.asarray(vl), jnp.asarray(bt), key)
    assert lg.shape == (1, B, logits[0].shape[-1])
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(lg)[0, 0],
                               rtol=1e-4, atol=1e-4)
    dec = j_build_mixed_step(jcfg, mesh, layout, jcc, B, Sq=1,
                             return_logits=True, donate=False)
    for i in range(N_NEW - 1):
        ti = np.zeros((1, B, 1), np.int32)
        ti[:, 0, 0] = ref[i]
        pos = np.zeros((1, B), np.int32)
        pos[:, 0] = P0 + i
        vl = np.zeros((1, B), np.int32)
        vl[:, 0] = 1
        _, kv, lg = dec(pack, kv, jnp.asarray(ti), jnp.asarray(pos),
                        jnp.asarray(vl), jnp.asarray(bt), key)
        np.testing.assert_allclose(logits[i + 1].numpy(),
                                   np.asarray(lg)[0, 0], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("layout", ["tp", "ep", "tpep"])
def test_out_of_vocab_ids_read_as_repro(setup, layout):
    """Prompt ids past the vocab (the launcher's traces draw up to 1000
    against a reduced config's 256; ROADMAP C19): the port's prefill step
    gives repro's logits, ids past the table read as repro's jnp gather
    reads them (the last row where the table is whole, zeros from the
    vocab-sharded lookup)."""
    jcfg, cfg, jp, tp, _, _ = setup
    prompt = [5, 300, 999, 17, 255, 256]
    B, Sq, P0 = 4, 8, len(prompt)
    ti = np.zeros((1, B, Sq), np.int32)
    ti[:, 0, :P0] = prompt
    vl = np.zeros((1, B), np.int32)
    vl[:, 0] = P0
    bt = np.zeros((1, B, 8), np.int32)
    bt[:, 0, :3] = [1, 2, 3]
    pos = np.zeros((1, B), np.int32)
    cc = CacheConfig(**CC)
    pack = build_decode_pack(cfg, pack_params(cfg, tp, layout, 1), layout, 1)
    step = build_mixed_step(cfg, (1, 1), layout, cc, B, Sq=Sq,
                            return_logits=True, device="cpu")
    T = torch.from_numpy
    _, _, lg = step(pack, torch.zeros((1, 1, cc.nelems(cfg, 1))), T(ti),
                    T(pos), T(vl), T(bt))
    jcc = JCacheConfig(**CC)
    jpack = j_build_decode_pack(jcfg, j_pack_params(jcfg, jp, layout, 1),
                                layout, 1)
    pre = j_build_mixed_step(jcfg, make_mesh((1, 1), ("data", "model")),
                             layout, jcc, B, Sq=Sq, return_logits=True,
                             donate=False)
    _, _, jlg = pre(jpack, jnp.zeros((1, 1, jcc.nelems(jcfg, 1)),
                                     jnp.float32),
                    jnp.asarray(ti), jnp.asarray(pos), jnp.asarray(vl),
                    jnp.asarray(bt),
                    jax.random.key_data(jax.random.PRNGKey(1)))
    np.testing.assert_allclose(lg[0, 0].numpy(), np.asarray(jlg)[0, 0],
                               rtol=1e-4, atol=1e-4)
