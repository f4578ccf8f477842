"""The port's photonlint gate, on the port's own tree.

1. ``photon_ml_tpu_torch/`` produces no finding beyond the committed
   baseline, and a replay through the incremental cache is
   byte-identical to the cold run.
2. ``python -m photon_ml_tpu_torch.tools.photonlint --format json``
   exits 0 in an interpreter that never imports ``jax`` or the JAX
   package.
3. On the live tree the JAX linter and the port's give equal findings
   for W4, W5, W9 and WA.
4. Canaries: a copy of the port's tree, seeded with one known violation
   each, turns the run red — a removed ``record_host_fetch`` (W104), a
   renamed ``fault_point`` (W401 and W402), a dropped snapshot read
   (W502), an undocumented metric (WB01), a typo'd axis in the score
   exchange's ``qpsum`` (W601), a ``qpsum`` moved under ``if
   dist.get_rank() == 0:`` (W602) and the gang's bf16 product with its
   f32 upcast deleted (W801).
5. The CLI refuses what the port does not run (W2, W3, W7, W803) with
   exit 2 and lists it as waiting.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from photon_ml_tpu.analysis import runner as jax_runner
from photon_ml_tpu_torch.analysis import runner

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = "photon_ml_tpu_torch"
BASELINE = REPO_ROOT / PORT / "tools" / "photonlint_baseline.json"
README = REPO_ROOT / "README.md"


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """One incremental cache for the module: the gate's cold run fills
    it, the later runs reuse its per-file artifacts."""
    return tmp_path_factory.mktemp("photonlint_torch_cache")


def _format_failure(report):
    lines = ["the port's photonlint found NEW violations (fix them, "
             "suppress with # photonlint: allow-<rule>(reason), or "
             "baseline them with `python -m "
             "photon_ml_tpu_torch.tools.photonlint --write-baseline`):",
             ""]
    lines += [f"  {f.format()}" for f in report.new]
    return "\n".join(lines)


def test_port_has_no_new_findings(cache_dir):
    report = runner.lint(REPO_ROOT, readme=README, baseline=BASELINE,
                         cache_dir=cache_dir)
    assert report.ok, _format_failure(report)
    assert report.cache_stats["file_misses"] > 0
    assert report.files_checked > 100
    assert not report.stale_baseline, report.stale_baseline
    again = runner.lint(REPO_ROOT, readme=README, baseline=BASELINE,
                        cache_dir=cache_dir)
    assert again.cache_stats["program_hit"]
    assert again.format_json() == report.format_json(), \
        "cached replay must be byte-identical to the cold run"


def test_cli_json_exit_zero_without_jax(cache_dir):
    code = (
        "import json, runpy, sys\n"
        f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        "sys.argv = ['photonlint', '--format', 'json', '--cache-dir', "
        f"{str(cache_dir)!r}]\n"
        "try:\n"
        "    runpy.run_module('photon_ml_tpu_torch.tools.photonlint', "
        "run_name='__main__', alter_sys=True)\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'photon_ml_tpu' or "
        "m.startswith('photon_ml_tpu.') or m == 'torch' or "
        "m.startswith('torch.'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad}), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    # -I: a fresh interpreter that reads no PYTHON* variables or user site
    proc = subprocess.run([sys.executable, "-I", "-c", code],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tail = json.loads(proc.stderr.strip().splitlines()[-1])
    assert tail == {"rc": 0, "bad": []}
    payload = json.loads(proc.stdout)
    assert payload["ok"] is True and payload["new"] == []
    assert payload["files_checked"] > 100


def test_live_tree_equals_the_jax_linter(cache_dir):
    families = {"W4", "W5", "W9", "WA"}
    port = runner.lint(REPO_ROOT, paths=[PORT], readme=README,
                       families=families, cache_dir=cache_dir)
    jax = jax_runner.lint(REPO_ROOT, paths=[PORT], readme=README,
                          families=families)

    def key(report):
        return [(f.rule, f.path, f.line, f.col, f.message)
                for f in report.new + report.suppressed]

    assert key(port) == key(jax)
    # the drill's own step key, and the chaos campaign's four reads of a
    # reply's or a telemetry record's kind (WA02 takes them for dispatch
    # arms), are the findings, each suppressed with its reason
    assert sorted((f.rule, f.path) for f in port.suppressed) == [
        ("W501", f"{PORT}/tools/crash_resume_drill.py")] + [
        ("WA02", f"{PORT}/tools/chaos_drill.py")] * 4


def _seed(path: Path, old: str, new: str) -> None:
    src = path.read_text()
    assert src.count(old) == 1, f"{path.name} lost {old!r}"
    path.write_text(src.replace(old, new))


def test_canaries_turn_the_run_red(tmp_path, cache_dir):
    shutil.copytree(REPO_ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    shutil.copy(README, tmp_path / "README.md")
    pkg = tmp_path / PORT
    cd = pkg / "game" / "coordinate_descent.py"
    _seed(cd, '        record_host_fetch(site="cd.epilogue")\n', "")
    _seed(pkg / "serve" / "service.py", 'fault_point("serve.swap"',
          'fault_point("serve.swap_v2"')
    _seed(cd, 'int(snap.get("consecutive_failures", 0))', "0")
    with open(cd, "a") as fh:
        fh.write("\n\ndef _photonlint_canary_metric():\n"
                 "    REGISTRY.counter(\"photonlint_canary_metric\").inc()\n")
    re_mod = pkg / "game" / "random_effect.py"
    _seed(re_mod, "num_samples),\n                     ENTITY_AXIS,",
          'num_samples),\n                     "entty",')
    agg = pkg / "ops" / "aggregators.py"
    _seed(agg, "    value = qpsum(value, axis_name, mode=collective_quant)\n",
          "    import torch.distributed as dist\n"
          "    if dist.get_rank() == 0:\n"
          "        value = qpsum(value, axis_name, mode=collective_quant)\n")
    gang = pkg / "parallel" / "multihost.py"
    _seed(gang, "gather_rows(X_t.to(torch.float32) @ w_dev)",
          "gather_rows(X_t @ w_dev)")
    report = runner.lint(tmp_path, readme=tmp_path / "README.md",
                         baseline=BASELINE, cache_dir=cache_dir)
    got = {(f.rule, f.path) for f in report.new}
    lines = cd.read_text().splitlines()
    w104 = [f for f in report.new if f.rule == "W104"]
    assert [lines[f.line - 1].strip() for f in w104] == [
        "p.ready.synchronize()"], [f.format() for f in report.new]
    assert ("W401", f"{PORT}/serve/service.py") in got
    assert any(f.rule == "W402" and "`serve.swap`" in f.message
               for f in report.new)
    assert any(f.rule == "W502" and "'consecutive_failures'" in f.message
               for f in report.new)
    assert any(f.rule == "WB01" and "photonlint_canary_metric" in f.message
               for f in report.new)
    w601 = [f for f in report.new if f.rule == "W601"]
    assert [f.path for f in w601] == [f"{PORT}/game/random_effect.py"]
    assert "'entty'" in w601[0].message
    w602 = [f for f in report.new if f.rule == "W602"]
    assert [f.path for f in w602] == [f"{PORT}/ops/aggregators.py"]
    assert "dist.get_rank()" in w602[0].message
    w801 = [f for f in report.new if f.rule == "W801"]
    assert [(f.path, gang.read_text().splitlines()[f.line - 1].strip())
            for f in w801] == [(f"{PORT}/parallel/multihost.py",
                                "scores_fixed = gather_rows(X_t @ w_dev)")]
    assert {r for r, _ in got} == {"W104", "W401", "W402", "W502", "WB01",
                                   "W601", "W602", "W801"}


def test_cli_refuses_what_the_port_does_not_run():
    cli = [sys.executable, "-m", "photon_ml_tpu_torch.tools.photonlint",
           "--no-cache"]
    env = {**os.environ, "PYTHONPATH": str(REPO_ROOT)}
    for extra, needle in ((["--rules", "W1,W2"], "W2"),
                          (["--rules", "W3"], "W3"),
                          (["--rules", "W6,W7"], "W7"),
                          (["--rules", "W8,W803"], "W803"),
                          (["--trace-evidence", "spans"], "W7"),
                          (["--rules", "WZ"], "unknown")):
        proc = subprocess.run(cli + extra, capture_output=True, text=True,
                              timeout=120, cwd=REPO_ROOT, env=env)
        assert proc.returncode == 2, proc.stdout + proc.stderr
        assert needle in proc.stderr
        assert proc.stdout == ""
    proc = subprocess.run(cli[:3] + ["--list-rules"], capture_output=True,
                          text=True, timeout=120, cwd=REPO_ROOT, env=env)
    assert proc.returncode == 0
    rows = [line.split("  ", 1) for line in proc.stdout.splitlines()]
    run = {rule[:2] for rule, what in rows
           if not what.startswith("waiting")}
    assert run == {"W0", "W1", "W4", "W5", "W6", "W8", "W9", "WA", "WB"}
    waiting = [rule for rule, what in rows if what.startswith("waiting")]
    assert waiting == ["W2", "W3", "W7", "W803"]
    assert "W803" not in {rule for rule, what in rows
                          if not what.startswith("waiting")}
