"""The most device memory the caching allocator held over the window
(``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``)."""


def read(r):
    if not r.peak_window_bytes:
        return None
    return r.peak_window_bytes / 2 ** 30
