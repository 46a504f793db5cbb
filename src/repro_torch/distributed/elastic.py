"""Elastic world size and rank-failure recovery (port of
repro/distributed/elastic.py, the serving half and the rescale check).

Serving: a lost rank's KV is host-recoverable metadata + re-prefill: the
affected requests' prompts are extended by their generated tokens (teacher-
forced) and re-enter the prefill queue; no other rank's state is touched.
The TP->EP greedy partitioner doubles as the rebalancing step afterwards.

Rank failure is the degenerate case of a cross-world shrink (DESIGN.md
§13): the blast-radius classification routes through the shared
`core.switch.plan_rank_shrink` planner, the same ownership diff an
elastic world-size switch uses.

Training: re-mesh via the layout-agnostic checkpoint (`elastic_restore`):
the on-disk form is global-logical, so restoring at another group size G
reshards. The port has no mesh object: the caller gives G.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.switch import plan_rank_shrink


@dataclass(frozen=True)
class RescalePlan:
    old_shape: dict
    new_shape: dict
    compatible: bool
    reason: str = ""


def plan_rescale(cfg, old_mesh_shape: dict, new_mesh_shape: dict,
                 layout: str) -> RescalePlan:
    """Validate a mesh change (divisibility constraints per layout)."""
    G_new = new_mesh_shape.get("model", 1)
    ok, why = True, ""
    if cfg.num_heads and cfg.num_heads % G_new and G_new % cfg.num_heads:
        ok, why = False, f"heads {cfg.num_heads} !~ model axis {G_new}"
    if cfg.is_moe:
        # experts must tile the model axis in one direction: E % G == 0
        # (each rank owns E/G experts) or G % E == 0 (experts replicated
        # across rank subgroups)
        if cfg.num_experts % G_new and G_new % cfg.num_experts:
            ok, why = False, (f"experts {cfg.num_experts} !~ "
                              f"model axis {G_new}")
    return RescalePlan(old_mesh_shape, new_mesh_shape, ok, why)


def elastic_restore(ckpt_path: str, cfg, layout: str, G: int, *,
                    device="cuda"):
    """Restore a checkpoint onto a group of G ranks (the rescale
    operation): (params, opt, step), as restore_checkpoint."""
    from repro_torch.distributed.checkpoint import restore_checkpoint
    return restore_checkpoint(ckpt_path, cfg, layout, G, device=device)


# ---------------------------------------------------------------------------
# Serving-side failure recovery
# ---------------------------------------------------------------------------

def fail_rank(engine, data_group: int, rank: int) -> list:
    """Simulate losing model-rank `rank` of `data_group`: every request whose
    KV touches that rank loses its cache and is rescheduled via re-prefill.

    Under EP only the rank's own requests are hit; under TP every request in
    the group holds a head-shard there, so the whole group re-prefills —
    the capacity/blast-radius asymmetry of the two layouts.

    Legal DURING a chunked switch (DESIGN.md §12): the in-flight session is
    aborted first — its staged buffers and planned dst pages (which may
    target the failed rank) are dropped wholesale — then the recovery runs
    against the still-live source layout. A per-rank (EP) failure also
    marks the rank's page pool dead so placement avoids it until every hit
    request has re-prefilled (degraded-mode serving).
    """
    in_flight = getattr(engine, "switch_in_progress", None)
    if in_flight is not None and in_flight():
        engine.abort_switch(f"rank {rank} of group {data_group} failed "
                            f"mid-switch")
    # fused decode: consume in-flight tokens so every request sits at a
    # step boundary (requeueing mid-flight would leave a live device slot
    # writing KV through a stale block table into released pages)
    engine._drain_decode()
    per_rank = engine.active.kv_per_rank
    # blast radius = the shared cross-world ownership diff's shrink case
    hit = plan_rank_shrink(
        list(engine.running.values()) + list(engine.prefilling),
        data_group, rank, per_rank)
    # the failed rank's cached prefixes are gone with its memory: drop the
    # affected pool's index (per-rank pool under EP; whole group when the
    # pooled view sharded every page's heads across the rank)
    if getattr(engine, "prefix", None) is not None:
        engine.prefix[data_group].drop_pool(rank if per_rank else 0)
    # degraded mode: a per-rank failure takes its pool out of prefill
    # placement until the recovery completes
    sched = getattr(engine, "sched", None)
    if per_rank and sched is not None:
        sched.mark_pool_dead(data_group, rank)
    for r in hit:
        # release pages (to the recorded pool), teacher-force the generated
        # prefix, vacate the device slot, re-prefill — the engine's shared
        # requeue path (the one preemption uses)
        engine.requeue_for_reprefill(r)
    note = getattr(engine, "note_rank_failure", None)
    if note is not None:
        note(data_group, rank, hit, per_rank and sched is not None)
    return hit
