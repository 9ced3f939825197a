"""peak_mem_gib: torch.cuda.max_memory_allocated() over the whole run
(set-up, capture and window), read when the window closes, in GiB."""

UNIT = "GiB"


def read(run):
    p = run.record.peak_bytes
    return p / 2 ** 30 if p else None
