"""setup_s: process start to window start (host clock): imports, the
kernels' build where the checkout has none yet, the weights, the engine,
its graph captures and the warm-up requests."""


def read(run):
    return run.setup_s
