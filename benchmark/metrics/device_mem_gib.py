"""The device memory one planner holds, in GiB (2**30 bytes):
`torch.cuda.max_memory_reserved` at the end of the window's first stretch,
over set-up and one capture; the stretches after it run on graphs the
benchmark captures anew, whose pools the allocator does not all give back."""


def read(ctx):
    return ctx.memory_peak_bytes / 2**30 if ctx.memory_peak_bytes else None
