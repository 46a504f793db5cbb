"""Checkpoints in the port, in repro's on-disk format (CPU).

The port's round trips: a checkpoint saved from tp or ep at one G
restores into either layout at G 2 or 4 equal to the direct pack of the
same weights (the MoE experts and the dense model's rank-major MLP
unpacked to the canonical form); async saves with the optimizer state;
`elastic_restore` at another G. Across frameworks: a checkpoint repro
wrote (f32) restores in the port, one the port wrote restores in repro,
and a bf16 one repro wrote restores in the port byte-exact, while the
port writes repro's exact file bytes for it. repro's own restore of that
bf16 checkpoint raises a TypeError (ROADMAP C22): the test pins it.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import pack_params as j_pack
from repro.distributed import checkpoint as jck
from repro.models.registry import init_params as j_init
from repro_torch.bridge import params_from_jax
from repro_torch.core.layouts import pack_params
from repro_torch.distributed import checkpoint as tck
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.models.registry import init_params
from repro_torch.configs import get_config
from repro_torch.training.data import MarkovData
from repro_torch.training.optimizer import (AdamWConfig, adamw_init, leaves,
                                            tree_map)
from repro_torch.training.train_loop import build_train_step
from tests._torch_common import port_tiny_dense, port_tiny_moe

torch.set_num_threads(1)


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


@pytest.fixture(params=["moe", "dense"])
def model(request):
    cfg = port_tiny_moe() if request.param == "moe" else port_tiny_dense()
    return cfg, init_params(cfg, 3, device="cpu")


@pytest.mark.parametrize("src,G_src", [("tp", 2), ("ep", 2), ("ep", 4)])
def test_port_round_trips_across_layouts_and_worlds(model, tmp_path, src,
                                                    G_src):
    cfg, glob = model
    stored = pack_params(cfg, glob, src, G_src)
    tck.save_checkpoint(str(tmp_path / "ck"), cfg, stored, src, G_src,
                        step=11)
    for dst in ("tp", "ep"):
        for G in (2, 4):
            got, opt, step = tck.restore_checkpoint(str(tmp_path / "ck"), cfg,
                                                    dst, G, device="cpu")
            assert step == 11 and opt is None
            _equal(got, pack_params(cfg, glob, dst, G))
    _equal(tck.to_canonical(cfg, stored, src, G_src),
           tck.to_canonical(cfg, pack_params(cfg, glob, "tp", 4), "tp", 4))


def test_async_save_with_optimizer_state_and_elastic_restore(tmp_path):
    cfg = port_tiny_moe()
    stored = pack_params(cfg, init_params(cfg, 0, device="cpu"), "tp", 2)
    opt = adamw_init(stored)
    opt = {"m": tree_map(lambda t: t + 0.5, opt["m"]), "v": opt["v"],
           "step": 7}
    t = tck.save_checkpoint(str(tmp_path / "ck"), cfg, stored, "tp", 2,
                            opt_state=opt, step=7, async_save=True)
    # the snapshot was taken before save returned: writing now changes
    # nothing on disk
    keep = tree_map(lambda x: x.clone(), stored)
    tree_map(lambda x: x.add_(1.0), stored)
    t.join(timeout=60)
    got, gopt, step = tck.restore_checkpoint(str(tmp_path / "ck"), cfg, "tp",
                                             2, with_opt=True, device="cpu")
    assert step == 7 and gopt["step"] == 7
    _equal(got, keep)
    _equal({"m": gopt["m"], "v": gopt["v"]}, {"m": opt["m"], "v": opt["v"]})
    g4, _, _ = elastic_restore(str(tmp_path / "ck"), cfg, "ep", 4,
                               device="cpu")
    _equal(g4, pack_params(cfg, tck.to_canonical(cfg, keep, "tp", 2), "ep",
                           4))


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_repro_written_checkpoint_restores_in_port(tiny_moe, tiny_dense,
                                                   family, tmp_path):
    jc = tiny_moe if family == "moe" else tiny_dense
    tc = port_tiny_moe() if family == "moe" else port_tiny_dense()
    jglob = j_init(jc, jax.random.PRNGKey(5))
    jck.save_checkpoint(str(tmp_path / "ck"), jc, j_pack(jc, jglob, "ep", 2),
                        "ep", 2, step=9)
    got, _, step = tck.restore_checkpoint(str(tmp_path / "ck"), tc, "tp", 4,
                                          device="cpu")
    assert step == 9
    want = pack_params(tc, params_from_jax(jax.tree.map(np.asarray, jglob),
                                           "cpu"), "tp", 4)
    _equal(got, want)


@pytest.mark.parametrize("family", ["moe", "dense"])
def test_port_written_checkpoint_restores_in_repro(tiny_moe, tiny_dense,
                                                   family, tmp_path):
    jc = tiny_moe if family == "moe" else tiny_dense
    tc = port_tiny_moe() if family == "moe" else port_tiny_dense()
    jglob = j_init(jc, jax.random.PRNGKey(6))
    tglob = params_from_jax(jax.tree.map(np.asarray, jglob), "cpu")
    tck.save_checkpoint(str(tmp_path / "ck"), tc,
                        pack_params(tc, tglob, "tp", 2), "tp", 2, step=4)
    got, _, step = jck.restore_checkpoint(str(tmp_path / "ck"), jc, "ep", 4)
    assert step == 4
    want = j_pack(jc, jglob, "ep", 4)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bf16_repro_checkpoint(path):
    """mixtral-8x7b reduced in bf16, packed ep at G = 2, saved by repro."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    jc = j_get_config("mixtral-8x7b").reduced(param_dtype=jnp.bfloat16,
                                              compute_dtype=jnp.bfloat16)
    tc = get_config("mixtral-8x7b").reduced(param_dtype=torch.bfloat16,
                                            compute_dtype=torch.bfloat16)
    jglob = j_init(jc, jax.random.PRNGKey(8))
    jck.save_checkpoint(path, jc, j_pack(jc, jglob, "ep", 2), "ep", 2,
                        step=2)
    return jc, tc, jglob


def test_repro_bf16_checkpoint_restores_byte_exact_in_port(tmp_path):
    """The port reads repro's bf16 leaves ('<V2' .npy, "bfloat16" in the
    manifest) by the manifest's dtype, byte-exact, into tp at G 2; and
    writing the same tree gives repro's exact file bytes."""
    jc, tc, jglob = _bf16_repro_checkpoint(str(tmp_path / "repro"))
    man = json.loads((tmp_path / "repro" / "manifest.json").read_text())
    assert "bfloat16" in {leaf["dtype"] for leaf in man["leaves"]}
    got, _, step = tck.restore_checkpoint(str(tmp_path / "repro"), tc, "tp",
                                          2, device="cpu")
    assert step == 2
    tglob = params_from_jax(jax.tree.map(np.asarray, jglob), "cpu")
    assert tglob["embed"].dtype == torch.bfloat16
    _equal(got, pack_params(tc, tglob, "tp", 2))
    tck.save_checkpoint(str(tmp_path / "port"), tc,
                        pack_params(tc, tglob, "ep", 2), "ep", 2, step=2)
    for f in sorted((tmp_path / "repro").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / f.name).read_bytes(), \
            f.name


def test_repro_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """ROADMAP C22 (repro's own fault; repro stays as it is): np.load gives
    a void array for a bf16 leaf and repro's from_canonical hands it to
    jnp.asarray."""
    jc, _, _ = _bf16_repro_checkpoint(str(tmp_path / "repro"))
    with pytest.raises(TypeError, match="V2"):
        jck.restore_checkpoint(str(tmp_path / "repro"), jc, "tp", 2)


def test_resume_keeps_the_vocab_pad_rows(tmp_path):
    """paligemma-3b reduced at V 1000 (padded to 1024; untied head): the
    loss runs over the padded vocab, so training moves the head's pad
    rows, which the canonical form drops. A checkpoint with the optimizer
    state after 3 steps restores byte-exact, pad rows included, and 3
    steps from it give the losses of 6 unbroken steps."""
    cfg = get_config("paligemma-3b").reduced(vocab_size=1000)
    step, init = build_train_step(
        cfg, "tp", 2, opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=6), device="cpu")
    data = MarkovData(cfg.vocab_size, 16, 2, seed=7)
    patches = torch.zeros((2, cfg.num_patches, cfg.d_model))

    def run(params, st, lo, hi):
        out = []
        for i in range(lo, hi):
            params, st, m = step(params, st,
                                 dict(data.batch_at(i), patches=patches))
            out.append(float(m["loss"]))
        return params, st, out

    params, st, first = run(*init(0), 0, 3)
    assert float(params["lm_head"][1000:].detach().abs().max()) > 0
    assert params["lm_head"].shape[0] == 1024
    tck.save_checkpoint(str(tmp_path / "ck"), cfg, params, "tp", 2,
                        opt_state=st, step=3)
    keep = tree_map(lambda t: t.detach().clone(), params)
    keep_m = tree_map(lambda t: t.clone(), st["m"])
    _, _, whole = run(params, st, 3, 6)
    got, gst, s = tck.restore_checkpoint(str(tmp_path / "ck"), cfg, "tp", 2,
                                         with_opt=True, device="cpu")
    assert s == 3 and gst["step"] == 3
    _equal(got, keep)
    _equal(gst["m"], keep_m)
    _, _, rest = run(got, gst, 3, 6)
    np.testing.assert_array_equal(rest, whole)
