"""Scheduling helpers of the serving engine (counterpart of ``repro/sched/``)."""
