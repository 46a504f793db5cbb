"""switch_pause_ms: the mean decode-blocked time of the layout switches
in the window (`SwitchRecord.pause_s`, core/switch_exec.py, host clock,
synchronised), in ms. Nothing to read where no switch ran."""


def read(run):
    s = run.win.switches
    return sum(r.pause_s for r in s) / len(s) * 1e3 if s else None
