"""gen_tok_s: output tokens that reached the host inside the window, over
the window's seconds (host clock). Closed rollout traffic: the card sets
the pace."""


def read(run):
    return run.win.tokens / run.win.seconds
