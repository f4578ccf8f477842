"""Shared pieces of the port's chaos-campaign tests (``test_torch_chaos*``):
a per-module workdir with its own fixture and reference, a deadline for
each test, and the cell lookup by report name."""

from __future__ import annotations

import contextlib
import signal

from photon_ml_tpu_torch.tools import chaos_drill as tchaos


class CellTimeout(AssertionError):
    pass


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test after ``seconds``: SIGALRM raises in the main thread,
    which unwinds the campaign's ``subprocess.run`` (killing its child)
    and its ``finally`` blocks (killing its services)."""
    def _expire(signum, frame):
        raise CellTimeout(f"test exceeded its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def campaign_workdir(tmp_path_factory, name: str) -> dict:
    """A workdir of this module's own: the fixture and the fault-free
    reference objective, on the CPU."""
    workdir = str(tmp_path_factory.mktemp(name))
    fixture = tchaos.build_fixture(workdir)
    with deadline(240):
        ref = tchaos.run_reference(fixture, workdir, device="cpu")
    return {"workdir": workdir, "fixture": fixture, "reference": ref}


def cell_named(name: str, smoke: bool = True) -> dict:
    """The cell of the port's table named ``point=mode[@variant]``."""
    for c in tchaos.build_cells(smoke):
        full = f"{c['point']}={c['mode']}"
        if c["variant"]:
            full += f"@{c['variant']}"
        if full == name:
            return c
    raise KeyError(name)


def run_named(campaign: dict, name: str, seconds: float,
              smoke: bool = True) -> dict:
    """Run the cell ``name`` through the port's ``run_cell`` on the CPU
    within ``seconds``; the report entry."""
    with deadline(seconds):
        return tchaos.run_cell(cell_named(name, smoke), campaign["fixture"],
                               campaign["workdir"], campaign["reference"],
                               device="cpu")
