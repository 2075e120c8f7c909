"""peak_mem_mib: torch.cuda.max_memory_allocated() over the window, reset
at its start, in MiB; nothing off a card."""


def read(ctx):
    return ctx.peak_bytes / 2**20 if ctx.peak_bytes > 0 else None
