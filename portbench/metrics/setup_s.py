"""setup_s (end to end, host clock): from the process's start to the
window's first request: imports, the card's context, the kernel libraries
(built on a checkout's first run), the pool of worlds, the warm
requests."""


def read(ctx):
    return ctx["setup_s"]
