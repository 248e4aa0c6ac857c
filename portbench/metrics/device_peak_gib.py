"""Peak device memory the port allocated over its import, set-up and
window (``torch.cuda.max_memory_allocated()``, reset once the dataset
was made and read before the reference touches the card), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
