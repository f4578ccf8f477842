"""Count the CUDA devices from a timed subprocess.

Port of ``photon_ml_tpu/utils/backend_probe.py:32-72``. Initialising a
device runtime can hang rather than fail, so code that must survive that
(a multi-device check before it builds a mesh) counts the devices in a
child process with a hard timeout before it touches CUDA itself. The
child is sent SIGTERM first and SIGKILL only after a grace period.

Where the JAX package returns ``None`` and falls back to the CPU, the
port raises ``RuntimeError`` naming the reason (the child failed, hung,
printed no count, or saw no CUDA device): the port never runs on the CPU
when a card was asked for.
"""

from __future__ import annotations

import subprocess
import sys

#: Allowance for a healthy but cold runtime's first initialisation.
DEFAULT_PROBE_TIMEOUT_SECS = 240

_PROBE = ("import torch; "
          "print(torch.cuda.device_count() if torch.cuda.is_available() "
          "else 0)")


def probe_cuda_devices(timeout_secs: int = DEFAULT_PROBE_TIMEOUT_SECS
                       ) -> int:
    """The number of CUDA devices a fresh interpreter sees (at least 1);
    raises ``RuntimeError`` with the reason otherwise."""
    proc = subprocess.Popen([sys.executable, "-c", _PROBE],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout_secs)
    except subprocess.TimeoutExpired:
        proc.terminate()  # SIGTERM first: let the runtime release the card
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        raise RuntimeError(f"CUDA device probe hung > {timeout_secs}s; "
                           "the port does not fall back to the CPU")
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA device probe rc={proc.returncode}; the "
                           "port does not fall back to the CPU")
    # the last line only: a site hook may print before the count
    last = out.strip().splitlines()[-1] if out.strip() else ""
    try:
        n = int(last)
    except ValueError:
        raise RuntimeError(f"CUDA device probe returned unparsable output "
                           f"{last!r}") from None
    if n < 1:
        raise RuntimeError("CUDA device probe found no CUDA device; the "
                           "port does not fall back to the CPU")
    return n
