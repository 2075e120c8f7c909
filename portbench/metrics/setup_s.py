"""setup_s: from the process's start to the window's start (imports, the
card, kernel libraries, the terrain made and packed, the objects' texture
written, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
