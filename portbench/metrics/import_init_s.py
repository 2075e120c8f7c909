"""import_init_s: from the process's start to the port imported and the
card initialised (host clock)."""


def read(ctx):
    return ctx.import_init_s
