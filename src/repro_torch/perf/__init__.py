"""Scenario fleet + perf-regression gate (the port's perf contract).

Three pieces, layered over the runtime and the cycle simulator:

* :mod:`repro_torch.perf.workloads` — deterministic, seeded descriptor
  workload generators (paged-KV serving bursts, MoE dispatch storms, mixed
  chain shapes, defragmentation churn) parameterized by every arch in
  :mod:`repro_torch.configs.registry`; byte-identical to the reference's;
* :mod:`repro_torch.perf.sweep` — drives every (config x workload x
  channels x mem-latency) cell through
  :class:`repro_torch.runtime.DMARuntime` on the chosen device and
  :func:`repro_torch.core.simulator.simulate_multichannel`, plus the mmu
  and transform cells, in the schema of ``BENCH_perf.json``;
* :mod:`repro_torch.perf.gate` — baseline comparison (median-of-N,
  per-metric tolerance bands) that exits nonzero on regression:
  ``python -m repro_torch.perf.gate --baseline BENCH_perf.json``.

DESIGN.md §4 documents the contract (metrics, bands, re-baselining).
"""
import importlib

# Lazy re-exports: sweep and gate are also `python -m` entrypoints, and an
# eager import here would shadow runpy's module execution (RuntimeWarning).
_EXPORTS = {
    "Scale": "workloads", "Workload": "workloads",
    "WORKLOAD_NAMES": "workloads", "generate": "workloads",
    "SCHEMA_VERSION": "sweep", "run_sweep": "sweep",
    "default_spec": "sweep", "SweepSpec": "sweep",
    "GateError": "gate", "Regression": "gate", "compare": "gate",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
