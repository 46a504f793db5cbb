"""Whether what the timed path served is correct.

After the window: a sample, drawn from the seed, of the requests that
finished in it, with the longest among them and some that were live
across a layout switch; the plain reference (`reference/<name>.py`, float32,
TF32 off) runs once over each prompt with its served tokens, on weights
drawn again from the seed. At every served position the number read is
the gap by which the served token's reference logit lies below the
reference's best there (0 where the served token is the reference's
argmax). The run is correct when the mean of those gaps (or, where the
cell's limits say so, that mean over the mean gap of the reference's own
path in the configuration's precision on the same sequences) is within
the cell's limit and enough tokens were compared; the widest gap is
printed beside it.

The same reading serves the control (`control.py`): there the tokens are
the ones a lower precision puts first at each position of the same
sequences.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

MIN_TOKENS = 200          # served tokens the check must compare at least
SAMPLE_TOKENS = 4000      # it stops adding requests past this many
SAMPLE_REQUESTS = 8       # ... and this many requests
SAMPLE_CAP = 24000        # prompt + served tokens the reference runs at most
SWITCHED = 3              # requests live across a switch, where there are


def pick_sample(recs, seed: int) -> list:
    done = [r for r in recs if r.done is not None and r.req.output]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), 5])
    order = [done[i] for i in rng.permutation(len(done))]
    longest = max(done, key=lambda r: (len(r.req.output), -r.req.rid))
    pick = [longest]
    pick += [r for r in order if r.at_switch and r is not longest][:SWITCHED]
    seen = {id(r) for r in pick}
    total = sum(len(r.req.prompt) + len(r.req.output) for r in pick)
    served = sum(len(r.req.output) for r in pick)
    for r in order:
        if served >= SAMPLE_TOKENS and len(pick) >= SAMPLE_REQUESTS:
            break
        n = len(r.req.prompt) + len(r.req.output)
        if id(r) in seen or total + n > SAMPLE_CAP:
            continue
        pick.append(r)
        seen.add(id(r))
        total += n
        served += len(r.req.output)
    return pick


def reference_module(config: dict):
    return importlib.import_module(f"reference.{config['reference']}")


def sequences(pick) -> tuple[list, list, list]:
    """(token lists, the rows whose logits predict the served tokens,
    the served tokens)."""
    seqs, rows, served = [], [], []
    for r in pick:
        P, out = len(r.req.prompt), list(r.req.output)
        seqs.append(list(r.req.prompt) + out[:-1])
        rows.append(list(range(P - 1, P - 1 + len(out))))
        served.append(out)
    return seqs, rows, served


def gaps(ref, m: dict, weights: dict, seqs, rows, tokens, mm=None
         ) -> list:
    """Per sequence, the reference module `ref`'s gap (best logit minus
    the logit of tokens[i][j]) at each row, float32 unless `mm` says
    otherwise; a token outside the vocabulary reads inf."""
    kw = {} if mm is None else {"mm": mm}
    V = m["vocab_size"]
    out = [np.zeros(len(r)) for r in rows]
    if not seqs:
        return out
    with torch.inference_mode():
        for i, pos, lg in ref.forward_rows(m, weights, seqs, rows, **kw):
            j0 = int(pos[0]) - rows[i][0]
            tok = torch.tensor(tokens[i][j0:j0 + len(pos)], device=lg.device)
            ok = (tok >= 0) & (tok < V)
            got = lg.gather(1, tok.clamp(0, V - 1)[:, None])[:, 0]
            g = torch.where(ok, lg.max(1).values - got,
                            torch.full_like(got, float("inf")))
            out[i][j0:j0 + len(pos)] = g.cpu().numpy()
    return out


def argmax_tokens(ref, m: dict, weights: dict, seqs, rows, mm) -> list:
    """The token each row puts first under the product `mm`."""
    out = [np.zeros(len(r), np.int64) for r in rows]
    if not seqs:
        return []
    with torch.inference_mode():
        for i, pos, lg in ref.forward_rows(m, weights, seqs, rows, mm=mm):
            j0 = int(pos[0]) - rows[i][0]
            out[i][j0:j0 + len(pos)] = lg.argmax(1).cpu().numpy()
    return [o.tolist() for o in out]


def strict_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def readings(g: list) -> dict:
    allg = np.concatenate(g) if g else np.zeros(0)
    if not len(allg):
        return {"max_gap": float("inf"), "tokens": 0,
                "mean_gap": float("inf"), "off_argmax": 0}
    return {"max_gap": float(allg.max()), "tokens": int(len(allg)),
            "mean_gap": float(allg.mean()),
            "off_argmax": int((allg > 0).sum())}


def ratio(read: dict, same: dict) -> float:
    """A mean gap in units of the reference's own mean gap in the
    configuration's precision on the same positions."""
    return read["mean_gap"] / same["mean_gap"] if same["mean_gap"] > 0 \
        else float("inf")


#: the numbers a cell's limits may compare, each read by `readings` (or,
#: for the ratio, by run.py beside it)
COMPARED = ("mean_gap", "gap_ratio_same")


def verdict(read: dict, limits: dict) -> tuple[bool, dict]:
    """The numbers compared, each beside its limit, and whether all
    hold: those of COMPARED that the cell's limits name (the widest gap
    is read and printed, not compared: see PERF.md), and the count of
    positions compared."""
    checks = {k: {"value": read[k], "limit": float(limits[k]),
                  "holds": read[k] <= float(limits[k])}
              for k in COMPARED if k in limits}
    if not checks:
        raise ValueError("the cell's limits name no number to compare")
    nmin = int(limits.get("min_tokens", MIN_TOKENS))
    checks["tokens_compared"] = {"value": read["tokens"], "limit": nmin,
                                 "holds": read["tokens"] >= nmin}
    return all(c["holds"] for c in checks.values()), checks
