"""Train-step factory (port of repro/training/train_loop.py).

The step is plain torch autograd through the port's global-math forward
(`models/registry.loss_fn` -> `transformer.lm_forward`): attention by
`flash_attention`, experts by `moe_ffn_global`, no hand-written kernel and
no backward kernel (repro's training path reaches no Pallas kernel
either). The parameters are `core/layouts.pack_params`' stored form for
`tp`, `ep` or `tpep` (vocab padded, rank-major experts, the dense MLP
rank-major), the same function of the same weights in every layout; the
gradients come back in that form.

The step owns the params it updates: it updates them in place (repro
donates them), but a param that neither `init_fn` nor an earlier step
returned is cloned first, once. So a step on `pack_params(cfg, glob,
...)`, whose embedding, attention and norm leaves are the caller's own
`glob` tensors, leaves `glob` as it was. The moments are the optimizer's
own and are updated in place as handed over.

repro's shardings (`make_shardings`, the ZeRO axis of the moments,
`batch_specs`) place this math over a device mesh and change no number.
With the ranks of a group stacked in one process they have no
counterpart: `G` (and `expert_G` for `tpep`) set only the stored form, and
the launcher's `--zero` and data axes set nothing (launch/train.py).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core.layouts import get_layout, pack_params
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import init_params, loss_fn
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, leaves, tree_map)


def build_train_step(cfg: ModelConfig, layout: str, G: int, *,
                     opt: AdamWConfig | None = None, grad_accum: int = 1,
                     remat: bool = True, expert_G: int | None = None,
                     device="cuda"):
    """Returns (step_fn, init_fn).

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics):
    batch holds tokens / labels (B, S) [+ frames / patches stubs], as
    tensors or numpy arrays; params and the moments are updated in place
    (repro donates them; a caller's param is cloned first, see the module
    docstring). metrics: loss, grad_norm (0-dim tensors), lr.
    With grad_accum > 1 the batch is cut into that many micro-batches
    along B, their fp32 gradients and losses summed and divided by the
    count (repro's `lax.scan`). init_fn(seed) -> (params, opt_state): the
    port's seeded `init_params` on `device`, packed for `layout`."""
    if cfg.is_mla:
        raise NotImplementedError("training a latent-attention (MLA) model "
                                  "is not supported: the port serves it")
    opt = opt or AdamWConfig()
    dev = require_device(device)
    lay = (get_layout(layout).expert_layout(cfg, G, expert_G)
           if cfg.is_moe else None)

    def loss_of(params, batch):
        return loss_fn(cfg, params, batch, lay=lay, remat=remat)

    def value_and_grad(params, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss = loss_of(params, batch)
        gs = torch.autograd.grad(loss, ps)
        it = iter(gs)
        return loss.detach(), tree_map(lambda _: next(it), params)

    owned = weakref.WeakValueDictionary()     # id -> a param the step made

    def own(tree, fresh=False):
        """The tree with each leaf the step did not make cloned (not when
        `fresh`: the leaves are new, nobody else holds them)."""
        def one(t):
            if not fresh and owned.get(id(t)) is not t:
                t = t.detach().clone()
            owned[id(t)] = t
            return t
        return tree_map(one, tree)

    def on_device(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def step_fn(params, opt_state, batch):
        batch = on_device(batch)
        params = own(params)
        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lsum = 0.0
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, g = value_and_grad(params, mb)
                with torch.no_grad():
                    tree_map(lambda a, b: a.add_(b), gsum, g)
                del g
                lsum = lsum + l
            grads = tree_map(lambda g: g.div_(grad_accum), gsum)
            loss = lsum / grad_accum
        else:
            loss, grads = value_and_grad(params, batch)
        params, opt_state, m = adamw_update(opt, params, grads, opt_state)
        m["loss"] = loss
        return params, opt_state, m

    def init_fn(seed: int = 0):
        params = own(pack_params(cfg, init_params(cfg, seed, device=dev),
                                 layout, G, expert_G=expert_G), fresh=True)
        return params, adamw_init(params)

    return step_fn, init_fn
