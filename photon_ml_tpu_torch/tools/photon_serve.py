"""photon-serve: the always-on GAME scoring service, and its control verbs.

Port of ``tools/photon_serve.py``. With no verb it runs the service
(``photon_ml_tpu_torch.serve.service``, whose module form is the same)::

    python -m photon_ml_tpu_torch.tools.photon_serve \\
        --game-model-input-dir out/best \\
        --listen unix:/tmp/serve.sock \\
        --feature-shard-id-to-feature-section-keys-map \\
            "global:globalFeatures|user:userFeatures" \\
        --random-effect-id-set userId [--device cpu]

``swap`` asks a RUNNING service to hot-swap to a retrained model (load,
shadow-scoring canary, atomic generation flip); it blocks until the swap
resolves, prints the ``swap_result`` JSON and exits 0 on ``ok``, 1 on
``refused``::

    python -m photon_ml_tpu_torch.tools.photon_serve swap \\
        --endpoint unix:/tmp/serve.sock --model-dir out/retrained \\
        [--model-id v2]

``fleet`` runs the entity-sharded front-end router over N already
running members (``photon_ml_tpu_torch.serve.router``, the JAX launcher's
``:80-82``; host-only: it takes no ``--device``), and exits 75 on
SIGTERM::

    python -m photon_ml_tpu_torch.tools.photon_serve fleet \
        --listen unix:/tmp/fleet.sock \
        --members unix:/tmp/m0.sock,unix:/tmp/m1.sock \
        --route-id userId [--trace-dir fleet-trace]

Each member is a service started as above (on its card by default), or
the JAX package's: the wire is the same.

``stats`` prints a running service's ``stats`` reply (generation, last
swap, qps, p50/p99, tiers and their hits, the ``serve_stage_ms`` totals)
as JSON and exits 0::

    python -m photon_ml_tpu_torch.tools.photon_serve stats \\
        --endpoint unix:/tmp/serve.sock
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.serve.protocol import ServeClient


def swap_main(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(
        prog="photon-serve swap",
        description="hot-swap a running scoring service to a new model")
    p.add_argument("--endpoint", required=True,
                   help="the service's listen endpoint (host:port or "
                        "unix:/path.sock)")
    p.add_argument("--model-dir", required=True,
                   help="candidate model dir (same layout the service "
                        "booted from)")
    p.add_argument("--model-id", default=None,
                   help="id the new generation reports (default: the "
                        "model dir's basename)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds to wait for the swap to resolve "
                        "(load + canary can span many batches)")
    ns = p.parse_args(argv)
    with ServeClient(ns.endpoint, timeout=ns.timeout) as client:
        result = client.swap(os.path.abspath(ns.model_dir),
                             model_id=ns.model_id)
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0 if result.get("outcome") == "ok" else 1


def stats_main(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(
        prog="photon-serve stats",
        description="print a running scoring service's stats")
    p.add_argument("--endpoint", required=True)
    p.add_argument("--timeout", type=float, default=30.0)
    ns = p.parse_args(argv)
    with ServeClient(ns.endpoint, timeout=ns.timeout) as client:
        print(json.dumps(client.stats(), indent=2, sort_keys=True))
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "swap":
        return swap_main(argv[1:])
    if argv and argv[0] == "stats":
        return stats_main(argv[1:])
    if argv and argv[0] == "fleet":
        from photon_ml_tpu_torch.serve.router import main as fleet_main

        fleet_main(argv[1:])
        return 0
    from photon_ml_tpu_torch.serve.service import main as serve_main

    serve_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
