"""The device memory the process reserved at its peak over the whole run,
set-up included (torch.cuda.max_memory_reserved), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
