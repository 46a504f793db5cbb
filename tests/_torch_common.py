"""Shared setup of the port's cross-framework tests (tests/test_torch_*.py).

The tiny MoE config is conftest's `tiny_moe`, built once per framework from
the same keyword arguments; weights come from repro's `init_params` and
cross to torch through `repro_torch.bridge`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY_MOE_KW = dict(num_heads=8, num_kv_heads=2, head_dim=8, d_model=32,
                   num_layers=2, num_experts=8, top_k=2, d_expert=32,
                   vocab_size=256, capacity_factor=8.0)


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
