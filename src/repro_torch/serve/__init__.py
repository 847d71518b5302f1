"""Serving: the slot engine, and the paged engine with admission control
and chunked prefill."""

from repro_torch.serve.engine import (
    DispatchStats,
    EngineCore,
    Request,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.paged_kv import PagedKVCache, PageExhausted, PageTable
from repro_torch.serve.scheduler import (
    AdmissionError,
    PagedRequest,
    PagedServeConfig,
    PagedServeEngine,
)

__all__ = [
    "AdmissionError",
    "DispatchStats",
    "EngineCore",
    "PagedKVCache",
    "PagedRequest",
    "PagedServeConfig",
    "PagedServeEngine",
    "PageExhausted",
    "PageTable",
    "Request",
    "ServeConfig",
    "ServeEngine",
]
