"""Device: the card's peak of allocated memory over the window, in GB
(torch.cuda.max_memory_allocated after reset_peak_memory_stats)."""


def read(ctx):
    if not ctx.on_card:
        return None
    return ctx.peak_window_bytes / 1e9
