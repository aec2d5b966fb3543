"""peak_device_mib: the caching allocator's peak of device memory over the
window, after its statistics were reset at the window's start."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**20
