"""Continuous-batching serving (counterpart of ``repro/serving/``)."""
