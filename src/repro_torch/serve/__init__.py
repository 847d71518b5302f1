"""Serving: the slot engine, and the paged engine with admission control
and chunked prefill, each decoding through the compiled step of
:mod:`repro_torch.serve.graphs`."""

from repro_torch.serve.engine import (
    DispatchStats,
    EngineCore,
    Request,
    ServeConfig,
    ServeEngine,
    serve_gemm_div,
)
from repro_torch.serve.graphs import DecodeStep, disable_graphs, step_mode
from repro_torch.serve.paged_kv import PagedKVCache, PageExhausted, PageTable
from repro_torch.serve.scheduler import (
    AdmissionError,
    PagedRequest,
    PagedServeConfig,
    PagedServeEngine,
)

__all__ = [
    "AdmissionError",
    "DecodeStep",
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
    "disable_graphs",
    "serve_gemm_div",
    "step_mode",
]
