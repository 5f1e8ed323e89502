"""siddhi_tpu_torch — the PyTorch / CUDA port of siddhi_tpu.

Streaming SQL / complex event processing with the same SiddhiQL surface and
`SiddhiManager` / `InputHandler` / callback API as `siddhi_tpu`, running on
an NVIDIA GPU.  `SiddhiManager()` runs on CUDA and raises when no CUDA
device exists; `SiddhiManager(device="cpu")` runs the plain PyTorch path.

This package never imports `jax` or `siddhi_tpu`.
"""
from .core.event import Event
from .core.runtime import (
    InputHandler,
    QueryCallback,
    SiddhiAppRuntime,
    SiddhiManager,
    StreamCallback,
)
from . import query_api

__version__ = "0.1.0"
__all__ = [
    "Event", "InputHandler", "QueryCallback", "SiddhiAppRuntime",
    "SiddhiManager", "StreamCallback", "query_api",
]
