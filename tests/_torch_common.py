"""Shared setup of the port's cross-framework tests (tests/test_torch_*.py).

The tiny configs are conftest's `tiny_moe` and `tiny_dense`, built once per
framework from the same keyword arguments; weights come from repro's `init_params` and
cross to torch through `repro_torch.bridge`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY_MOE_KW = dict(num_heads=8, num_kv_heads=2, head_dim=8, d_model=32,
                   num_layers=2, num_experts=8, top_k=2, d_expert=32,
                   vocab_size=256, capacity_factor=8.0)


TINY_DENSE_KW = dict(num_heads=8, num_kv_heads=2, head_dim=8, d_model=32,
                     num_layers=2, d_ff=64, vocab_size=256)


def port_tiny_dense():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").reduced(
        **TINY_DENSE_KW, param_dtype=torch.float32,
        compute_dtype=torch.float32)


def port_tiny_moe():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").reduced(
        **TINY_MOE_KW, param_dtype=torch.float32, compute_dtype=torch.float32)


def jax_params(jcfg, seed: int = 0):
    """repro's params for `jcfg` and the same tree as torch tensors."""
    from repro.models.registry import init_params
    from repro_torch.bridge import params_from_jax
    jp = init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def to_jnp(t: torch.Tensor):
    return jnp.asarray(t.numpy())


def assert_greedy_agree(jcfg, jp, prompts: dict, got: dict, ref: dict,
                        margin: float = 1e-4) -> int:
    """The port's greedy tokens `got` equal repro's `ref` (rid -> tokens)
    wherever repro's top-2 logit margin clears `margin` (ROADMAP C3): a
    request is compared position by position up to its first difference,
    which must sit where repro's margin (its `lm_forward` teacher-forced on
    the prompt and `ref`) is at most `margin`; past it the two streams
    condition on different tokens. Returns how many positions the margin
    excluded."""
    from repro.models.transformer import lm_forward
    assert set(got) == set(ref)
    excluded = 0
    for rid, want in ref.items():
        if list(got[rid]) == list(want):
            continue
        assert len(got[rid]) == len(want), (rid, got[rid], want)
        seq = list(prompts[rid]) + list(want)
        lg = np.asarray(lm_forward(jcfg, jp, jnp.array([seq[:-1]]),
                                   remat=False))[0, len(prompts[rid]) - 1:]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        for j, (a, b) in enumerate(zip(got[rid], want)):
            if a == b:
                continue
            assert top2[j, 1] - top2[j, 0] <= margin, (
                rid, j, list(got[rid]), list(want))
            excluded += len(want) - j
            break
    return excluded
