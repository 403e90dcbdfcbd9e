"""Serving: the bucketed ``Engine`` (monolithic caches, the plain
attention) and the continuous-batching ``Scheduler`` over a paged KV
pool (K4 and K5 on the card), with the host-side page accounting."""
from .engine import (  # noqa: F401
    Engine,
    GenerationResult,
    bucket_requests,
    check_capacity,
    check_queue_capacity,
    check_unique_rids,
    derive_request_keys,
    numerics_ctx,
    sample_tokens,
)
from .paging import (  # noqa: F401
    PagePool,
    PageStats,
    check_page_capacity,
    pages_needed,
    prefix_page_hashes,
)
from .scheduler import (  # noqa: F401
    Request,
    RequestResult,
    Scheduler,
    ServeSession,
    ServeStats,
    SlotAllocator,
    StreamHandle,
    default_prefill_buckets,
)
