"""switch_kv_gbps: the rate at which the window's layout switches moved
the KV cache: the bytes their KV movers wrote, the copies that a pooled
(TP) view replicates included (`SwitchRecord.kv_bytes`,
core/switch_exec.py), over the time the movers took (`kv_s`, host clock,
synchronised), summed over the switches, in GB/s. Nothing to read where
no switch ran, where no KV moved, or where the program's records carry
no `kv_bytes`."""


def read(run):
    s = run.win.switches
    if not s or any(getattr(r, "kv_bytes", None) is None for r in s):
        return None
    nbytes = sum(r.kv_bytes for r in s)
    secs = sum(r.kv_s for r in s)
    if nbytes <= 0 or secs <= 0:
        return None
    return nbytes / secs / 1e9
