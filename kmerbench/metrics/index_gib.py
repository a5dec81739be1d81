"""index_gib (GiB): device memory the port holds for its index after
set-up, read from the device allocator by the harness (allocated bytes
after the warm-up, less those before the build; the harness's own buffers
are made before the build)."""


def read(run):
    if not run.index_bytes or run.index_bytes <= 0:
        return None
    return run.index_bytes / 2 ** 30
