"""Continuous-batching serving (counterpart of ``repro/serving/``): the
engine, its per-request sampling (``sampling.py``) and the draft
providers of speculative decode (``draft.py``)."""
from repro_torch.serving.engine import (  # noqa: F401
    BatchState,
    Completion,
    Engine,
    EngineStats,
    Request,
)
