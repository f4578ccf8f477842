"""Build attribution: the port's answer to "why was an executable built".

Port of ``photon_ml_tpu/obs/compile.py``, the compile half of
``--device-telemetry``. The JAX package attributes XLA compiles and
re-traces of its jitted entry points (``xla.compile`` / ``xla.retrace``
spans). The port has no jit and no re-trace; what it builds at run time,
and what a slow first step pays for, is:

- the ``nvcc`` build of a CUDA kernel library (``ops/kernels_build.py``,
  site ``kernels.nvcc:<stem>``);
- the ``g++`` build of the host library (``io/native_loader.py``, site
  ``host.gxx:<stem>``);
- the ``ColumnSumPlan`` of an ELL batch, laid out on its first column sum
  (``data/batch.py``, site ``data.column_sum_plan``).

Armed, each of them calls :func:`record_build` with its site, its cause
and its seconds, which writes the JAX record's fields:
``compiles{site}`` and ``compile_secs{site}`` counters, a
``compile_causes{site, cause}`` counter, and one ``build.compile`` span
(labels ``site``, ``cause``, ``secs`` and the site's own). The span's
name is the one intended difference from the JAX package's span names:
``build.compile`` stands where the JAX package writes ``xla.compile`` /
``xla.retrace``. Causes:

- ``no_cache_entry`` — no library of that name was built before (or,
  for a plan, the batch had none);
- ``source_or_flags_hash_changed`` — a library of the same name exists
  under another hash: its sources, flags or host changed.

A library found already built is a cache hit and records nothing, as a
jit dispatch-cache hit records nothing in the JAX package. Disarmed (the
default) :func:`record_build` is one module-global check.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Optional

from photon_ml_tpu_torch.obs import trace
from photon_ml_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

_ARMED = False
_REGISTRY: MetricsRegistry = REGISTRY

NO_CACHE_ENTRY = "no_cache_entry"
HASH_CHANGED = "source_or_flags_hash_changed"


def arm(registry: Optional[MetricsRegistry] = None) -> None:
    """Switch the build sites' attribution on (idempotent)."""
    global _ARMED, _REGISTRY
    _REGISTRY = registry or REGISTRY
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


def is_armed() -> bool:
    return _ARMED


def library_cause(out: str) -> str:
    """Why the library at ``out`` (``lib<stem>_<hash>.so``) has to be
    built: another hash of the same stem beside it means its sources or
    flags changed, none means there was no cache entry."""
    stem = os.path.basename(out).rsplit("_", 1)[0]
    others = [p for p in glob.glob(os.path.join(os.path.dirname(out),
                                                stem + "_*.so"))
              if p != out]
    return HASH_CHANGED if others else NO_CACHE_ENTRY


def record_build(site: str, cause: str, start_ns: int,
                 end_ns: Optional[int] = None, **labels) -> None:
    """Attribute one build at ``site`` that ran from ``start_ns`` to
    ``end_ns`` (``time.perf_counter_ns``; now when omitted). A no-op
    unless armed."""
    if not _ARMED:
        return
    end_ns = time.perf_counter_ns() if end_ns is None else end_ns
    secs = (end_ns - start_ns) / 1e9
    reg = _REGISTRY
    reg.counter("compiles").inc(site=site)
    reg.counter("compile_secs").inc(secs, site=site)
    reg.counter("compile_causes").inc(site=site, cause=cause)
    tracer = trace.get_tracer()
    if tracer is not None:
        # nested where it ran: under the span open on this thread
        trace.record_span("build.compile", start_ns, end_ns,
                          depth=len(tracer._stack()), site=site,
                          cause=cause, secs=round(secs, 6), **labels)
