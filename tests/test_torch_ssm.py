"""The port's Mamba2 SSD against its recurrence and against repro's
(f32, CPU).

Mirrors tests/test_ssm.py on the port (`ssd_chunked` == the naive
recurrence over the same cases; a decode step continuing a chunked scan
== the full scan), then holds each port function to repro's on the same
numpy inputs: `ssd_chunked` (with and without an initial state, t not a
multiple of the chunk), `ssd_decode_step`, and `ssm_forward` run as
prefill then decode with repro's weights through `repro_torch.bridge`.

Tolerances: the scan against the float64 recurrence 1e-4 (test_ssm.py's);
port against repro 1e-5 for the scan and the step (the same f32 einsums),
1e-4 for the whole block (its matmuls differ across frameworks by up to
7.6e-5, ROADMAP C3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline fallback (tests/_hypothesis_compat.py)
    from tests._hypothesis_compat import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)
REC_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


def _naive(x, dt, A, B, C):
    """tests/test_ssm.py's float64 recurrence."""
    b, t, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    rep = h // g
    Bf = np.repeat(np.asarray(B, np.float64), rep, 2)
    Cf = np.repeat(np.asarray(C, np.float64), rep, 2)
    xs = np.asarray(x, np.float64)
    dts = np.asarray(dt, np.float64)
    As = np.asarray(A, np.float64)
    hstate = np.zeros((b, h, p, n))
    ys = np.zeros((b, t, h, p))
    for i in range(t):
        dA = np.exp(dts[:, i] * As[None, :])
        upd = np.einsum("bh,bhn,bhp->bhpn", dts[:, i], Bf[:, i], xs[:, i])
        hstate = hstate * dA[..., None, None] + upd
        ys[:, i] = np.einsum("bhn,bhpn->bhp", Cf[:, i], hstate)
    return ys, hstate


def _inputs(seed, b, t, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, t, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(f)
    B = rng.standard_normal((b, t, g, n)).astype(f)
    C = rng.standard_normal((b, t, g, n)).astype(f)
    return x, dt, A, B, C


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@settings(deadline=None, max_examples=10)
@given(t=st.sampled_from([4, 7, 16, 33]), chunk=st.sampled_from([4, 8]),
       h=st.sampled_from([2, 4]), seed=st.integers(0, 50))
def test_ssd_chunked_matches_recurrence(t, chunk, h, seed):
    x, dt, A, B, C = _inputs(seed, 2, t, h, 4, 1, 8)
    y, hf = tssm.ssd_chunked(*_t(x, dt, A, B, C), chunk)
    ry, rh = _naive(x, dt, A, B, C)
    assert not torch.isnan(y).any()        # -inf in _segsum reaches exp as 0
    np.testing.assert_allclose(y.numpy(), ry, **REC_TOL)
    np.testing.assert_allclose(hf.numpy(), rh, **REC_TOL)


def test_decode_step_continues_chunked_scan():
    x, dt, A, B, C = _t(*_inputs(0, 1, 12, 2, 4, 1, 8))
    y_full, _ = tssm.ssd_chunked(x, dt, A, B, C, chunk=4)
    y_pre, state = tssm.ssd_chunked(x[:, :-1], dt[:, :-1], A, B[:, :-1],
                                    C[:, :-1], chunk=4)
    y_last, _ = tssm.ssd_decode_step(state, x[:, -1], dt[:, -1], A,
                                     B[:, -1], C[:, -1])
    np.testing.assert_allclose(y_last.numpy(), y_full[:, -1].numpy(),
                               **REC_TOL)


@pytest.mark.parametrize("t,chunk,g,init", [(16, 4, 1, False),
                                            (13, 8, 1, True),
                                            (9, 4, 2, True)])
def test_ssd_chunked_matches_repro(t, chunk, g, init):
    x, dt, A, B, C = _inputs(t + chunk, 2, t, 4, 4, g, 8)
    h0 = (np.random.default_rng(5).standard_normal((2, 4, 4, 8))
          .astype(np.float32) if init else None)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              init_state=None if h0 is None
                              else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*_t(x, dt, A, B, C), chunk,
                              init_state=None if h0 is None
                              else torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_ssd_decode_step_matches_repro():
    x, dt, A, B, C = _inputs(7, 3, 1, 4, 4, 2, 8)
    st0 = np.random.default_rng(8).standard_normal((3, 4, 4, 8)).astype(
        np.float32)
    jy, js = jssm.ssd_decode_step(jnp.asarray(st0), jnp.asarray(x[:, 0]),
                                  jnp.asarray(dt[:, 0]), jnp.asarray(A),
                                  jnp.asarray(B[:, 0]), jnp.asarray(C[:, 0]))
    ty, ts = tssm.ssd_decode_step(torch.from_numpy(st0),
                                  *_t(x[:, 0], dt[:, 0], A, B[:, 0],
                                      C[:, 0]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_ssm_forward_prefill_then_decode_matches_repro():
    """One Mamba2 block: a chunked prefill of 11 tokens (chunk 8, so a
    padded chunk), then three decode steps carrying its conv and SSM
    states, each output and state against repro's."""
    kw = dict(d_model=32, ssm_state=8, ssm_head_dim=8, ssm_chunk=8)
    jc = j_get_config("mamba2-780m").reduced(
        param_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    tc = get_config("mamba2-780m").reduced(**kw)
    jp = jssm.init_ssm(jc, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    # A_log / dt_bias drawn away from repro's zeros so decay and bias act
    rng = np.random.default_rng(4)
    for k, s in (("A_log", 0.5), ("dt_bias", 0.3)):
        a = (rng.standard_normal(tc.ssm_heads) * s).astype(np.float32)
        jp[k], tp[k] = jnp.asarray(a), torch.from_numpy(a.copy())
    u = rng.standard_normal((2, 14, 32)).astype(np.float32)
    jo, (jcs, jst) = jssm.ssm_forward(jc, jp, jnp.asarray(u[:, :11]))
    to, (tcs, tst) = tssm.ssm_forward(tc, tp, torch.from_numpy(u[:, :11]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **BLOCK_TOL)
    for i in range(11, 14):
        jo, (jcs, jst) = jssm.ssm_forward(jc, jp, jnp.asarray(u[:, i:i + 1]),
                                          conv_state=jcs, ssm_state=jst,
                                          decode=True)
        to, (tcs, tst) = tssm.ssm_forward(tc, tp,
                                          torch.from_numpy(u[:, i:i + 1]),
                                          conv_state=tcs, ssm_state=tst,
                                          decode=True)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK_TOL)
        for a, b in zip(tcs, jcs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **BLOCK_TOL)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst),
                                   **BLOCK_TOL)
