"""Layout-agnostic checkpointing with reshard-on-restore (port of
repro/distributed/checkpoint.py, in repro's on-disk format).

Canonical form: the GLOBAL logical params (experts unpacked to (L, E, 2I,
D), the dense MLP out of its rank-major form, vocab unpadded) as a torch
tree on the host. A checkpoint written from any layout or world restores
into any layout at any G.

Format (repro's): <dir>/manifest.json with `step`, `arch` and `leaves`
(tree, path, files, shape, dtype per leaf), and one .npy per leaf, chunked
along the first axis so a file stays under 256 MiB. A bf16 leaf is written
as its raw 2-byte values under repro's header (`'<V2'`, what numpy writes
for an ml_dtypes bfloat16 array) with "dtype": "bfloat16" in the manifest,
so the bytes equal repro's; restore reads the manifest's dtype and views
the 2-byte values as bf16 (numpy has no bfloat16 of its own). repro's own
restore cannot read a bf16 leaf back (ROADMAP C22).

What the port adds, in repro's "opt" tree (repro's restore hands that
tree back unread):
  * `opt.pad.params`: the rows past V of the padded `embed` / `lm_head`.
    The loss runs over the padded vocab, so training moves the head's pad
    rows; the canonical form drops them, and restore puts them back.
  * with `opt_state`: the moments `opt.m` / `opt.v` in the canonical form
    (they have the params' shapes) with their pad rows under `opt.pad.m`
    / `opt.pad.v`, and `opt.step`; so the optimizer state, like the
    params, restores into any layout at any G.

`save_checkpoint(..., async_save=True)` copies the trees to the host
first and writes the files on a thread: the train step updates its
tensors in place, so the snapshot is taken before it returns.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.layouts import get_layout, pack_params, padded_vocab
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import unpack_experts, unpack_w13
from repro_torch.models.transformer import mlp_global

_CHUNK_BYTES = 256 * 1024 * 1024


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set_path(tree, path, val):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = val


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


_TABLES = ("embed", "lm_head")


def _pad_rows(cfg: ModelConfig, tree: dict) -> dict:
    """The rows past V of the tree's padded vocab tables, on the host."""
    V = cfg.vocab_size
    return {k: tree[k][V:].detach().to("cpu", copy=True) for k in _TABLES
            if k in tree and tree[k].shape[0] == padded_vocab(V) > V}


def _put_pad_rows(cfg: ModelConfig, tree: dict, rows: dict) -> None:
    for k, r in rows.items():
        tree[k][cfg.vocab_size:] = r.to(tree[k].device)


def to_canonical(cfg: ModelConfig, params: dict, layout: str, G: int,
                 expert_G: int | None = None) -> dict:
    """Stored layout params -> global logical form (a torch tree on the
    host)."""
    out = _host(params)
    V, Vp = cfg.vocab_size, padded_vocab(cfg.vocab_size)
    for k in ("embed", "lm_head"):
        if k in out and out[k].shape[0] == Vp:
            out[k] = out[k][:V].clone()
    layers = out.get("layers", {})
    if cfg.is_moe and "moe" in layers:
        lay = get_layout(layout).expert_layout(cfg, G, expert_G)
        E = cfg.num_experts
        moe = dict(layers["moe"])
        moe["w13"] = torch.stack([unpack_w13(w, lay, E)
                                  for w in moe["w13"]])
        moe["w2"] = torch.stack([unpack_experts(w, lay, 2, E)
                                 for w in moe["w2"]])
        out["layers"] = {**layers, "moe": moe}
    elif "mlp" in layers:
        mlp = mlp_global(layers["mlp"], lead=1)
        out["layers"] = {**layers,
                         "mlp": {k: w.contiguous() for k, w in mlp.items()}}
    return out


def from_canonical(cfg: ModelConfig, canon: dict, layout: str, G: int, *,
                   expert_G: int | None = None, device="cuda") -> dict:
    """Global logical form -> stored layout params on `device`."""
    dev = require_device(device)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        return torch.as_tensor(t).to(dev)
    return pack_params(cfg, put(canon), layout, G, expert_G=expert_G)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _save_leaf(fn: Path, t: torch.Tensor) -> None:
    if t.dtype == torch.bfloat16:
        raw = t.contiguous().view(torch.int16).numpy()
        with open(fn, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(raw.shape)})
            f.write(raw.astype("<i2", copy=False).tobytes())
    else:
        np.save(fn, t.numpy())


def _load_leaf(fn: Path, dtype: str) -> torch.Tensor:
    a = np.load(fn)
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).view(np.int16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save_checkpoint(path: str, cfg: ModelConfig, params: dict, layout: str,
                    G: int, *, opt_state=None, step: int = 0,
                    async_save: bool = False, expert_G: int | None = None):
    """Write `params` (stored for `layout` at G) in the canonical form, as
    repro writes them, and in the "opt" tree their vocab pad rows and
    `opt_state`'s moments in the canonical form (module docstring).
    Returns the writer thread when async_save, else None."""
    def canon(tree):
        return to_canonical(cfg, tree, layout, G, expert_G)
    opt, pad = {}, {"params": _pad_rows(cfg, params)}
    if opt_state is not None:
        for k in ("m", "v"):
            opt[k] = canon(opt_state[k])
            pad[k] = _pad_rows(cfg, opt_state[k])
        opt["step"] = torch.tensor(opt_state["step"], dtype=torch.int32)
    pad = {k: v for k, v in pad.items() if v}
    if pad:
        opt["pad"] = pad
    trees = {"params": canon(params)}
    if opt:
        trees["opt"] = opt

    def _do():
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "arch": cfg.name, "leaves": []}
        for tname, tree in trees.items():
            for lp, leaf in _leaf_paths(tree):
                name = tname + "." + ".".join(lp) if lp else tname
                nchunk = max(1, -(-leaf.numel() * leaf.element_size()
                                  // _CHUNK_BYTES))
                nchunk = min(nchunk, max(1, leaf.shape[0]
                                         if leaf.dim() else 1))
                # np.array_split's pieces along the first axis
                pieces = ([leaf] if not leaf.dim() else leaf.tensor_split(
                    nchunk))
                files = []
                for ci, piece in enumerate(pieces):
                    fn = f"{name}.{ci}.npy"
                    _save_leaf(p / fn, piece)
                    files.append(fn)
                manifest["leaves"].append(
                    {"tree": tname, "path": list(lp), "files": files,
                     "shape": list(leaf.shape), "dtype": _dtype_name(leaf)})
        (p / "manifest.json").write_text(json.dumps(manifest))

    if async_save:
        t = threading.Thread(target=_do, daemon=True)
        t.start()
        return t
    _do()
    return None


def restore_checkpoint(path: str, cfg: ModelConfig, layout: str, G: int, *,
                       with_opt: bool = False, expert_G: int | None = None,
                       device="cuda"):
    """Restore into `layout` at group size G on `device`, the vocab pad
    rows put back. Returns (params, opt, step); opt is the optimizer
    state {m, v, step} packed for `layout` at G when with_opt and the
    checkpoint holds moments, else None (repro's launcher writes none)."""
    dev = require_device(device)
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    trees: dict = {"params": {}, "opt": {}}
    for leaf in manifest["leaves"]:
        parts = [_load_leaf(p / f, leaf["dtype"]) for f in leaf["files"]]
        t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        _set_path(trees[leaf["tree"]], tuple(leaf["path"]),
                  t.reshape(leaf["shape"]))
    opt, pad = trees["opt"], trees["opt"].get("pad", {})

    def restore(name, canon):
        tree = from_canonical(cfg, canon, layout, G, expert_G=expert_G,
                              device=dev)
        _put_pad_rows(cfg, tree, pad.get(name, {}))
        return tree
    params = restore("params", trees["params"])
    if not (with_opt and "m" in opt):
        return params, None, manifest["step"]
    return params, {"m": restore("m", opt["m"]), "v": restore("v", opt["v"]),
                    "step": int(opt["step"])}, manifest["step"]
