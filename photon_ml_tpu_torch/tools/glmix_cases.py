"""The GLMix configurations that exercise the port's three solvers.

One table, read by ``chip_smoke.py``, :func:`crash_resume_drill.driver_argv`
and the tests: for each case the task, the fixed-effect and per-user
optimization configurations in the drivers' ``maxIter,tol,lambda,
downSamplingRate,OPTIMIZER,REG`` form, the validation evaluators and any
further training-driver flags.

- ``lbfgs``: logistic regression, L-BFGS + L2 (the main path);
- ``linear_tron``: linear regression, TRON + L2, with
  ``--compute-variance`` (BASELINE config 2's family);
- ``poisson_enet``: Poisson regression, L-BFGS + elastic net (alpha 0.5),
  so OWL-QN (BASELINE config 3's family).

:data:`CD_EXTENSION_FLAGS` turn on the coordinate-descent extensions for
the ``lbfgs`` case: the pipelined sweep, blocks of two coordinates, lane
compaction with the auto-tuned chunk, and the fixed effect down-sampled
at rate 0.5.

:data:`FACTORED_CONFIG` is the factored per-user coordinate of
``chip_smoke.py`` phase 10 in the drivers' ``reCfg:latentCfg:mfCfg``
form: per-entity and latent L-BFGS + L2 (lambda 1, at most 20 iterations
each), two inner iterations, latent dimension 8 (``bench.py:1227``).
:data:`FACTORED_FLAGS` replace the ``lbfgs`` case's per-user coordinate
with it (``perUserFac``, IDENTITY-projected over the global shard, active
cap 128).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GlmixCase:
    task: str
    fixed: str
    per_user: str
    evaluators: str
    flags: tuple = ()

    def argv(self) -> list:
        """The case's training-driver flags."""
        return ["--task-type", self.task,
                "--fixed-effect-optimization-configurations",
                f"fixed:{self.fixed}",
                "--random-effect-optimization-configurations",
                f"perUser:{self.per_user}",
                "--evaluator-type", self.evaluators, *self.flags]


GLMIX_CASES = {
    "lbfgs": GlmixCase("LOGISTIC_REGRESSION", "40,1e-7,10,1,LBFGS,L2",
                       "20,1e-7,1,1,LBFGS,L2", "AUC,LOGISTIC_LOSS,AUC:userId"),
    "linear_tron": GlmixCase("LINEAR_REGRESSION", "15,1e-5,10,1,TRON,L2",
                             "15,1e-5,1,1,TRON,L2", "RMSE,SQUARED_LOSS",
                             ("--compute-variance", "true")),
    "poisson_enet": GlmixCase("POISSON_REGRESSION",
                              "40,1e-7,10,1,LBFGS,ELASTIC_NET",
                              "20,1e-7,1,1,LBFGS,ELASTIC_NET",
                              "POISSON_LOSS"),
}
SECOND_ORDER_CASES = ("linear_tron", "poisson_enet")
CD_EXTENSION_FLAGS = (
    "--cd-pipeline-depth", "1", "--cd-block-size", "2",
    "--re-lane-compaction-chunk", "auto",
    "--fixed-effect-optimization-configurations",
    "fixed:40,1e-7,10,0.5,LBFGS,L2")
FACTORED_CONFIG = "20,1e-7,1,1,LBFGS,L2:20,1e-7,1,1,LBFGS,L2:2,8"
FACTORED_FLAGS = (
    "--updating-sequence", "fixed,perUserFac",
    "--random-effect-data-configurations",
    "perUserFac:userId,global,1,128,-,-,identity",
    "--factored-random-effect-optimization-configurations",
    f"perUserFac:{FACTORED_CONFIG}")
