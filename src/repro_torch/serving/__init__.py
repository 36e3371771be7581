"""Continuous-batching serving of transformers (PyTorch): KV-cache
containers (slot and paged layouts), the chunked-prefill admission path,
the host-side page allocator with prefix reuse, the request scheduler and
its asyncio front door."""

from repro_torch.serving import (  # noqa: F401
    engine,
    kv_cache,
    paging,
    request,
    scheduler,
    server,
    weights,
)
