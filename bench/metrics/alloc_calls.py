"""``alloc_calls`` (calls per step): the caching allocator's calls that
map, allocate or free device memory (``num_alloc_retries``,
``num_device_alloc`` and ``num_device_free`` of ``torch.cuda.memory_stats``)
that the program counts in ``telemetry/profiler.COUNTERS`` during the
traced steps, per step."""
from bench.spans import counter_per_step


def read(ctx):
    return counter_per_step(ctx)
