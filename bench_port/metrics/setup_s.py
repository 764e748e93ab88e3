"""Process start to the first timed call: imports, CUDA context, kernel
libraries from the cache (or built), panels made on the card, the warm
calls."""


def read(run):
    return run.setup_s
