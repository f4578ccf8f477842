"""photonlint over the port: AST-based invariant checking for the
PyTorch/H100 package.

Port of ``photon_ml_tpu/analysis/``. The port inherits the JAX
package's hard contracts — one blocking fetch per update counted
through ``record_host_fetch``, the ``PHOTON_FAULTS`` table, the snapshot
keys, thread lifetimes and signal handlers, the wire kinds and the
telemetry taxonomy — and this subpackage checks them statically over
the port's whole tree, as the JAX package's linter does over its own.
It is stdlib ``ast`` only: nothing it lints is imported or executed, and
it imports neither torch nor the JAX package.

Families, with the same codes and meaning as the JAX linter's:

- **W0xx** suppression hygiene (malformed and stale directives);
- **W1xx** sync discipline in torch form — ``float``/``int``/``bool``,
  ``.item()``/``.tolist()``, ``np.asarray``/``.numpy()`` on a device
  tensor, and a blocking ``.cpu()`` / ``.to("cpu")`` / ``synchronize()``
  outside the instrumented fetch sites (see :mod:`.rules_sync`);
- **W4xx** fault-point drift against the README ``PHOTON_FAULTS`` table;
- **W5xx** checkpoint-schema drift;
- **W6xx** collective safety in torch form — axis names no mesh
  defines, collectives under control flow that branches on a per-shard
  value or on the process's identity, ``shard_map`` spec arity, over the
  shard runner, ``ProcessSpan`` and the gang (see
  :mod:`.rules_collectives`);
- **W8xx** precision discipline in torch form — a bf16/f16 reduction
  without an f32 accumulator, f64 on the card, implicit mixed precision
  in a loss path (see :mod:`.rules_dtype`);
- **W9xx** thread safety;
- **WAxx** wire-protocol drift over the port's ``serve/``;
- **WBxx** telemetry-taxonomy drift against the README tables and the
  port's table of names that differ.

W2, W3, W7 and W803 are not run (``core.WAITING`` says why). Entry
points: :func:`photon_ml_tpu_torch.analysis.runner.lint` (library) and
``python -m photon_ml_tpu_torch.tools.photonlint`` (CLI). Suppressions
use ``# photonlint: allow-<rule>(reason)``; the committed baseline is
``photon_ml_tpu_torch/tools/photonlint_baseline.json``.
"""

from photon_ml_tpu_torch.analysis.core import Finding, LintReport  # noqa: F401
from photon_ml_tpu_torch.analysis.runner import lint  # noqa: F401
