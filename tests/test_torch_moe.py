"""The port's MoE substrate against repro's (tiny_moe, f32, CPU).

Packing must be bit-exact; routing and the stacked-rank TP / EP decode
paths must match repro's global capacity-dispatch `moe_ffn_global` on the
same params (capacity_factor 8: no token is dropped, so every layout
computes the same function). Tolerance f32 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.distributed import ranks
from repro_torch.models import moe as tmoe
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup(tiny_moe):
    jp, tp = jax_params(tiny_moe)
    return tiny_moe, port_tiny_moe(), jp, tp


@pytest.mark.parametrize("layout,G", [("tp", 1), ("tp", 2), ("tp", 4),
                                      ("ep", 2), ("ep", 4), ("ep", 16)])
def test_pack_roundtrip_bit_exact(setup, layout, G):
    jcfg, cfg, jp, tp = setup
    E = cfg.num_experts
    lay = tmoe.make_expert_layout(E, G, layout)
    jlay = jmoe.make_expert_layout(E, G, layout)
    assert (lay.G, lay.ep, lay.tp_inner) == (jlay.G, jlay.ep, jlay.tp_inner)
    w13, w2 = tp["layers"]["moe"]["w13"], tp["layers"]["moe"]["w2"]
    jw13, jw2 = jp["layers"]["moe"]["w13"], jp["layers"]["moe"]["w2"]
    p13 = tmoe.pack_w13(w13[0], lay)
    p2 = tmoe.pack_experts(w2[0], lay, width_axis=2)
    np.testing.assert_array_equal(p13.numpy(),
                                  np.asarray(jmoe.pack_w13(jw13[0], jlay)))
    np.testing.assert_array_equal(
        p2.numpy(), np.asarray(jmoe.pack_experts(jw2[0], jlay, width_axis=2)))
    torch.testing.assert_close(tmoe.unpack_w13(p13, lay, E), w13[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(tmoe.unpack_experts(p2, lay, 2, E), w2[0],
                               rtol=0, atol=0)
    # the stacked-layer form packs every layer at once
    torch.testing.assert_close(tmoe.pack_w13(w13, lay, lead=1)[1],
                               tmoe.pack_w13(w13[1], lay), rtol=0, atol=0)


def test_route_matches_repro_and_breaks_ties_low(setup):
    jcfg, cfg, jp, tp = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, cfg.d_model), dtype=np.float32)
    x[3] = 0.0                      # uniform probs: a full tie
    router = tp["layers"]["moe"]["router"][0]
    g, e, p = tmoe.route(cfg, router, torch.from_numpy(x))
    jg, je, jpr = jmoe.route(jcfg, jp["layers"]["moe"]["router"][0],
                             jnp.asarray(x))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jpr), **TOL)
    assert e[3].tolist() == list(range(cfg.top_k))


@pytest.mark.parametrize("layout", ["tp", "ep"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_paths_match_global_moe(setup, layout, G):
    jcfg, cfg, jp, tp = setup
    T = 12
    rng = np.random.default_rng(G)
    x = rng.standard_normal((T, cfg.d_model), dtype=np.float32)
    jm = {k: v[0] for k, v in jp["layers"]["moe"].items()}
    ref = jmoe.moe_ffn_global(
        jcfg, jm, jnp.asarray(x), jmoe.make_expert_layout(
            cfg.num_experts, 1, "ep"))
    lay = tmoe.make_expert_layout(cfg.num_experts, G, layout)
    m = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    p = {"router": m["router"], "w13": tmoe.pack_w13(m["w13"], lay),
         "w2": tmoe.pack_experts(m["w2"], lay, width_axis=2)}
    xt = torch.from_numpy(x)
    if layout == "tp":               # batch replicated, partial sums psum'd
        out = ranks.psum(tmoe.moe_decode_tp(cfg, p, xt.expand(G, T, -1)))
        for g in range(G):
            np.testing.assert_allclose(out[g].numpy(), np.asarray(ref), **TOL)
    else:                            # each rank its own token slice
        out = tmoe.moe_decode_ep(cfg, p, xt.reshape(G, T // G, -1), lay)
        np.testing.assert_allclose(out.reshape(T, -1).numpy(),
                                   np.asarray(ref), **TOL)


def test_stacked_collectives_match_their_definitions():
    rng = np.random.default_rng(0)
    G, c = 4, 3
    x = torch.from_numpy(rng.standard_normal((G, G * c, 2)))
    ps = ranks.psum(x)
    for g in range(G):
        torch.testing.assert_close(ps[g], x.sum(0))
    a2a = ranks.all_to_all(x)
    for r in range(G):
        for s in range(G):
            torch.testing.assert_close(a2a[r, s * c:(s + 1) * c],
                                       x[s, r * c:(r + 1) * c])
    torch.testing.assert_close(ranks.all_to_all(a2a), x)
    pss = ranks.psum_scatter(x)
    for r in range(G):
        torch.testing.assert_close(pss[r], x.sum(0)[r * c:(r + 1) * c])
    ag = ranks.all_gather(x, axis=0, tiled=True)
    assert ag.shape == (G, G * G * c, 2)
    torch.testing.assert_close(ag[2], torch.cat(list(x), 0))
    agu = ranks.all_gather(x[:, 0])
    torch.testing.assert_close(agu[1], x[:, 0])
    assert ranks.axis_index(G, "cpu").tolist() == list(range(G))
