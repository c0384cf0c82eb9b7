"""The process's peak of allocated device memory
(``torch.cuda.max_memory_allocated``), read when the window has closed and
before the reference runs."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
