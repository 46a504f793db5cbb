"""The training path in the port (f32, CPU), against repro.

AdamW (moments, bias corrections, clipping by the raw global norm, the
warmup-cosine schedule), `MarkovData`, `load_balance_loss`, the int8 and
top-k compression with the error-feedback all-reduce over stacked ranks,
`chunked_all_to_all` and the analytic collective bytes, each against
repro's. Then `build_train_step` for tiny_moe in tp and ep and tiny_dense
in tp against repro's `build_train_step` at mesh (1, 1) in this process
and at (1, 2) in a 2-device subprocess, on repro's weights, compared
through the canonical form (the port stores the dense MLP rank-major,
repro stores it global): loss, grad norm and lr per step within 1e-5
relative, parameters after 3 steps within 1e-5 except where repro's
gradient fell under 1e-6 at some step, where lr x steps is allowed (Adam's
normalised step can flip sign on a gradient that is noise). `grad_accum`
2 equals 1 on the same batch.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro.distributed import compression as jcomp
from repro.models.moe import load_balance_loss as j_lbl
from repro.models.moe import route as j_route
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.layouts import pack_params
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.checkpoint import save_checkpoint, to_canonical
from repro_torch.models.moe import load_balance_loss, route
from repro_torch.models.registry import init_params
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import build_train_step
from tests._torch_common import TINY_DENSE_KW, TINY_MOE_KW
from tests.helpers import run_multidevice

torch.set_num_threads(1)
REL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEPS = 3
CASES = {"moe": ("mixtral-8x7b", TINY_MOE_KW),
         "dense": ("internlm2-1.8b", TINY_DENSE_KW)}


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# optimizer, schedule, data, aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [1.0, 0.0, 0.05])
def test_adamw_matches_repro(clip):
    """Five AdamW steps on a nested tree with changing gradients: params,
    moments, step counter and metrics (raw grad norm, lr) equal repro's."""
    rng = np.random.default_rng(int(clip * 100))
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    p0 = _tree(rng, shapes)
    cfg_kw = dict(lr=0.05, clip_norm=clip, warmup_steps=2, total_steps=8)
    jp = {"x": {k: jnp.asarray(v) for k, v in p0.items() if k != "b"},
          "b": jnp.asarray(p0["b"])}
    tp = {"x": {k: torch.from_numpy(v.copy()) for k, v in p0.items()
                if k != "b"}, "b": torch.from_numpy(p0["b"].copy())}
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(5):
        g = _tree(rng, shapes)
        jg = {"x": {k: jnp.asarray(v) for k, v in g.items() if k != "b"},
              "b": jnp.asarray(g["b"])}
        tg = {"x": {k: torch.from_numpy(v) for k, v in g.items()
                    if k != "b"}, "b": torch.from_numpy(g["b"])}
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg_kw), jp, jg,
                                       js)
        tp, ts, tm = topt.adamw_update(topt.AdamWConfig(**cfg_kw), tp, tg,
                                       ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=REL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=REL)
    assert ts["step"] == int(js["step"]) == 5
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for a, b in zip(topt.leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=REL,
                                       atol=1e-7)


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = topt.adamw_init(p)
    assert st["m"]["w"].dtype == torch.float32 and st["step"] == 0
    p, st, m = topt.adamw_update(topt.AdamWConfig(warmup_steps=1), p,
                                 {"w": torch.full((4,), 2.0,
                                                  dtype=torch.bfloat16)}, st)
    assert p["w"].dtype == torch.bfloat16 and st["v"]["w"].dtype == \
        torch.float32
    assert float(m["grad_norm"]) == 4.0         # raw norm, before clipping


@pytest.mark.parametrize("cfg_kw", [
    dict(warmup_steps=100, total_steps=10000),
    dict(warmup_steps=3, total_steps=20, min_lr_frac=0.0),
    dict(warmup_steps=0, total_steps=5, lr=1e-2)])
def test_schedule_matches_repro(cfg_kw):
    for s in (0, 1, 2, 3, 4, 5, 50, 99, 100, 101, 5000, 10000, 20000):
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg_kw),
                                   jnp.asarray(s, jnp.int32)))
        got = topt.schedule(topt.AdamWConfig(**cfg_kw), s)
        np.testing.assert_allclose(got, want, rtol=REL, atol=1e-12)


def test_global_norm_matches_repro():
    rng = np.random.default_rng(1)
    t = _tree(rng, {"a": (7, 3), "b": (11,)})
    want = float(jopt.global_norm({k: jnp.asarray(v) for k, v in t.items()}))
    got = float(topt.global_norm({k: torch.from_numpy(v)
                                  for k, v in t.items()}))
    np.testing.assert_allclose(got, want, rtol=REL)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 16, 4, 7),
                                                  (1000, 33, 3, 0)])
def test_markov_data_matches_repro(vocab, seq, batch, seed):
    j = jdata.MarkovData(vocab, seq, batch, seed=seed)
    t = tdata.MarkovData(vocab, seq, batch, seed=seed)
    for i in (0, 1, 5):
        a, b = j.batch_at(i), t.batch_at(i)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_load_balance_loss_matches_repro():
    from repro.configs import get_config as j_get_config
    jc = j_get_config("mixtral-8x7b").reduced(**TINY_MOE_KW)
    tc = get_config("mixtral-8x7b").reduced(**TINY_MOE_KW)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((jc.d_model, jc.num_experts)).astype(np.float32)
    _, je, jpr = j_route(jc, jnp.asarray(w), jnp.asarray(x))
    _, te, tpr = route(tc, torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    want = float(j_lbl(jpr, je, jc.num_experts))
    got = float(load_balance_loss(tpr, te, tc.num_experts))
    np.testing.assert_allclose(got, want, rtol=REL)
    # uniform routing gives 1
    E, k = 4, 2
    eids = torch.tensor([[0, 1], [2, 3], [1, 0], [3, 2]])
    assert float(load_balance_loss(torch.full((4, E), 1 / E), eids, E)) == \
        pytest.approx(1.0)


# ---------------------------------------------------------------------------
# compression and collectives
# ---------------------------------------------------------------------------

def test_int8_and_topk_match_repro():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 9)).astype(np.float32) * 3
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=REL)
    np.testing.assert_allclose(tcomp.dequantize_int8(tq, ts).numpy(),
                               np.asarray(jcomp.dequantize_int8(jq, js)),
                               rtol=REL)
    x[0, :3] = 5.0                                 # ties: lowest index first
    for frac in (0.1, 0.25, 1.0):
        jv, ji = jcomp.topk_sparsify(jnp.asarray(x), frac)
        tv, ti = tcomp.topk_sparsify(torch.from_numpy(x), frac)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=REL)
        np.testing.assert_allclose(
            tcomp.topk_densify(tv, ti, x.shape).numpy(),
            np.asarray(jcomp.topk_densify(jv, ji, x.shape)), rtol=REL)


@pytest.mark.parametrize("G", [2, 4])
def test_compressed_psum_int8_matches_repro(G):
    """The error-feedback int8 all-reduce over G stacked ranks against
    repro's under a named axis (vmap), two rounds with the residual
    carried."""
    rng = np.random.default_rng(G)
    g = rng.standard_normal((G, 5, 7)).astype(np.float32)
    res_j = jnp.zeros_like(jnp.asarray(g))
    res_t = torch.zeros(g.shape)
    fn = jax.vmap(lambda a, r: jcomp.compressed_psum_int8(a, "d", r),
                  axis_name="d")
    for _ in range(2):
        old = res_t
        js, res_j = fn(jnp.asarray(g), res_j)
        ts, res_t = tcomp.compressed_psum_int8(torch.from_numpy(g), res_t)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=REL,
                                   atol=1e-5)
        np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j),
                                   rtol=REL, atol=1e-6)
        # error feedback: what was sent is g + the old residual - the new
        sent = (torch.from_numpy(g) + old - res_t).sum(0)
        torch.testing.assert_close(ts[0], sent, rtol=1e-5, atol=1e-5)
        g = g * 0.5 + 0.1


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_chunked_all_to_all_matches_repro(n_chunks):
    G, c = 4, 2
    x = np.arange(G * G * c * 6 * 2, dtype=np.float32).reshape(G, G * c, 6,
                                                                2)
    want = jax.vmap(lambda a: jcoll.chunked_all_to_all(a, "d", n_chunks),
                    axis_name="d")(jnp.asarray(x))
    got = tcoll.chunked_all_to_all(torch.from_numpy(x), n_chunks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["qwen3-235b-a22b", "qwen2-moe-a2.7b",
                                  "qwen3-4b", "paligemma-3b", "zamba2-2.7b",
                                  "mamba2-780m"])
def test_collective_bytes_match_repro(arch):
    from repro.configs import get_config as j_get_config
    jc, tc = j_get_config(arch), get_config(arch)
    for layout in ("tp", "ep"):
        for B, G in ((8, 2), (32, 4)):
            assert tcoll.decode_collective_bytes(tc, layout, B, G) == \
                jcoll.decode_collective_bytes(jc, layout, B, G)
            assert tcoll.train_collective_bytes(tc, layout, 4096, G, 2,
                                                10**9) == \
                jcoll.train_collective_bytes(jc, layout, 4096, G, 2, 10**9)
    assert tcoll.switch_bytes(tc, 4, 5000) == jcoll.switch_bytes(jc, 4, 5000)


# ---------------------------------------------------------------------------
# the train step against repro's
# ---------------------------------------------------------------------------

_REPRO_TRAIN = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.layouts import pack_params
from repro.distributed.checkpoint import to_canonical
from repro.launch.mesh import make_mesh
from repro.models.registry import init_params
from repro.training.data import MarkovData
from repro.training.optimizer import AdamWConfig, adamw_init
from repro.training.train_loop import build_train_step


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + k + "/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def run(arch, kw, layout, G, steps, accum, opt):
    cfg = get_config(arch).reduced(**kw, param_dtype=jnp.float32,
                                   compute_dtype=jnp.float32)
    mesh = make_mesh((1, G), ("data", "model"))
    step, _, _ = build_train_step(cfg, mesh, layout, opt=AdamWConfig(**opt),
                                  grad_accum=accum, donate=False)
    params = pack_params(cfg, init_params(cfg, jax.random.PRNGKey(0)),
                         layout, G)
    st = adamw_init(params)
    data = MarkovData(cfg.vocab_size, 16, 4, seed=7)
    b1, clip = AdamWConfig(**opt).b1, AdamWConfig(**opt).clip_norm
    rec, small = [], None
    m_prev = flat(to_canonical(cfg, st["m"], layout, G))
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        params, st, met = step(params, st, b)
        rec.append([float(met[k]) for k in ("loss", "grad_norm", "lr")])
        # the step's gradient, read back from its first moment: m_t =
        # b1 m_(t-1) + (1 - b1) g scale, scale the clipping factor
        m_new = flat(to_canonical(cfg, st["m"], layout, G))
        scale = min(1.0, clip / (rec[-1][1] + 1e-9))
        g = {k: (m_new[k] - b1 * m_prev[k]) / (1 - b1) / scale
             for k in m_new}
        m = {k: np.abs(v) < 1e-6 for k, v in g.items()}
        small = m if small is None else {k: small[k] | m[k] for k in m}
        m_prev = m_new
    return rec, flat(to_canonical(cfg, params, layout, G)), small
"""

_REPRO_TRAIN_MAIN = """
import json
out = {{}}
arrays = {{}}
for name, (arch, kw, layout) in {runs}.items():
    rec, canon, small = run(arch, kw, layout, 2, {steps}, 1, {opt})
    out[name] = rec
    arrays.update({{name + ":p:" + k: v for k, v in canon.items()}})
    arrays.update({{name + ":s:" + k: v for k, v in small.items()}})
np.savez({path!r}, **arrays)
print(json.dumps(out))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + k + "/"))
        return out
    return {prefix[:-1]: tree.detach().numpy()}


def _port_run(family, layout, G, accum, jparams):
    arch, kw = CASES[family]
    cfg = get_config(arch).reduced(**kw)
    step, _ = build_train_step(cfg, layout, G, opt=topt.AdamWConfig(**OPT),
                               grad_accum=accum, device="cpu")
    params = pack_params(cfg, params_from_jax(jparams, "cpu"), layout, G)
    st = topt.adamw_init(params)
    data = tdata.MarkovData(cfg.vocab_size, 16, 4, seed=7)
    rec = []
    for i in range(STEPS):
        params, st, m = step(params, st, data.batch_at(i))
        rec.append([float(m["loss"]), float(m["grad_norm"]), m["lr"]])
    return rec, _flat(to_canonical(cfg, params, layout, G))


def _assert_runs_agree(got, want):
    rec, canon = got
    wrec, wcanon, small = want
    np.testing.assert_allclose(np.array(rec), np.array(wrec), rtol=REL)
    assert set(canon) == set(wcanon)
    slack = OPT["lr"] * STEPS
    for k, v in canon.items():
        w = wcanon[k]
        tol = np.where(small[k], slack + 1e-5, 1e-5 + 1e-5 * np.abs(w))
        assert (np.abs(v - w) <= tol).all(), (k, float(np.abs(v - w).max()))


def _jax_init(family):
    from repro.configs import get_config as j_get_config
    from repro.models.registry import init_params
    arch, kw = CASES[family]
    jc = j_get_config(arch).reduced(**kw, param_dtype=jnp.float32,
                                    compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, init_params(jc, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("family,layout,accum", [
    ("moe", "tp", 1), ("moe", "ep", 1), ("dense", "tp", 1),
    ("moe", "ep", 2)])
def test_train_step_matches_repro_at_mesh_1x1(family, layout, accum):
    ns = {}
    exec(_REPRO_TRAIN, ns)
    arch, kw = CASES[family]
    want = ns["run"](arch, kw, layout, 1, STEPS, accum, OPT)
    got = _port_run(family, layout, 1, accum, _jax_init(family))
    _assert_runs_agree(got, want)


def test_train_step_matches_repro_at_mesh_1x2(tmp_path):
    """tiny_moe in tp and ep, tiny_dense in tp (rank-major MLP in the
    port, global in repro), G = 2, repro in one 2-device subprocess."""
    runs = {"moe_tp": ("mixtral-8x7b", TINY_MOE_KW, "tp"),
            "moe_ep": ("mixtral-8x7b", TINY_MOE_KW, "ep"),
            "dense_tp": ("internlm2-1.8b", TINY_DENSE_KW, "tp")}
    path = str(tmp_path / "repro_train.npz")
    code = _REPRO_TRAIN + _REPRO_TRAIN_MAIN.format(runs=runs, steps=STEPS,
                                                   opt=OPT, path=path)
    recs = json.loads(run_multidevice(code, devices=2).strip()
                      .splitlines()[-1])
    arrays = np.load(path)
    for name in runs:
        family, layout = name.split("_")
        canon = {k.split(":", 2)[2]: arrays[k] for k in arrays.files
                 if k.startswith(name + ":p:")}
        small = {k.split(":", 2)[2]: arrays[k] for k in arrays.files
                 if k.startswith(name + ":s:")}
        got = _port_run(family, layout, 2, 1, _jax_init(family))
        _assert_runs_agree(got, (recs[name], canon, small))


def test_grad_accum_equals_one_batch():
    """Two micro-batches of 2 give the loss, grad norm and parameters of
    one batch of 4 (tiny_moe: its capacity drops no token at either
    size)."""
    out = {}
    for accum in (1, 2):
        out[accum] = _port_run("moe", "ep", 2, accum, _jax_init("moe"))
    np.testing.assert_allclose(np.array(out[2][0]), np.array(out[1][0]),
                               rtol=REL)
    for k, v in out[2][1].items():
        np.testing.assert_allclose(v, out[1][1][k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family,layout", [("moe", "ep"), ("dense", "tp")])
def test_step_leaves_the_callers_params_unchanged(family, layout):
    """A step on pack_params of the caller's global tree (whose embedding,
    attention and norm leaves the pack shares) changes neither that tree
    nor the pack: the step clones what it did not make, once, and updates
    its own copy in place from then on."""
    arch, kw = CASES[family]
    cfg = get_config(arch).reduced(**kw)
    glob = init_params(cfg, 0, device="cpu")
    want = topt.tree_map(lambda t: t.clone(), glob)
    params = pack_params(cfg, glob, layout, 2)
    packed = topt.tree_map(lambda t: t.clone(), params)
    step, _ = build_train_step(cfg, layout, 2, opt=topt.AdamWConfig(**OPT),
                               device="cpu")
    data = tdata.MarkovData(cfg.vocab_size, 16, 4, seed=7)
    new, st, _ = step(params, topt.adamw_init(params), data.batch_at(0))
    for tree, ref in ((glob, want), (params, packed)):
        for a, b in zip(topt.leaves(tree), topt.leaves(ref)):
            assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(topt.leaves(new), topt.leaves(packed)))
    again, _, _ = step(new, st, data.batch_at(1))
    assert all(a is b for a, b in zip(topt.leaves(again), topt.leaves(new)))


def test_launcher_resumes_in_another_layout_and_world(tmp_path):
    """launch/train.py --resume from a checkpoint written with the
    optimizer state in ep at G 2 after 3 of 6 steps, resumed in tp at
    G 4: the moments restore from the canonical form into the new layout,
    and the resumed losses equal an unbroken ep run's."""
    from repro_torch.launch.train import main
    base = ["--device", "cpu", "--arch", "qwen2-moe-a2.7b", "--reduced",
            "--steps", "6", "--batch", "2", "--seq", "16"]
    whole = main(base + ["--mesh", "1x2", "--layout", "ep"])["losses"]
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    step, init = build_train_step(
        cfg, "ep", 2, opt=topt.AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=6), device="cpu")
    params, st = init(0)
    data = tdata.MarkovData(cfg.vocab_size, 16, 2, seed=7)
    for i in range(3):
        params, st, m = step(params, st, data.batch_at(i))
        assert abs(float(m["loss"]) - whole[i]) <= REL * abs(whole[i])
    save_checkpoint(str(tmp_path), cfg, params, "ep", 2, opt_state=st,
                    step=3)
    rest = main(base + ["--mesh", "1x4", "--layout", "tp", "--ckpt",
                        str(tmp_path), "--resume"])
    assert rest["start"] == 3 and sorted(rest["losses"]) == [3, 4, 5]
    for i, x in rest["losses"].items():
        assert abs(x - whole[i]) <= REL * abs(whole[i]), (i, x, whole[i])
