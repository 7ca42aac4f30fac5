"""Policy gym: loadgen as a tuning environment.

Three layers:

- ``gym/env.py`` — :class:`PolicyGymEnv`: gym-style reset/step/rollout
  over the real loadgen ``ScenarioDriver`` (its own tick loop, exposed
  tick-at-a-time), rewarded by the scorer's deterministic objective;
- ``gym/tune.py`` — :class:`PopulationTuner`: a seeded cross-entropy /
  successive-halving population search whose concurrent rollouts coalesce
  estimator dispatches through the fleet admission queue;
- ``gym/ledger.py`` — the byte-stable tuning ledger
  (``autoscaler_tpu.gym.generation/1``, the JAX package's schema).

CLI: ``python -m autoscaler_tpu_torch.gym tune suite.json --device=cpu``.

The port of ``autoscaler_tpu/gym/``: rollouts run on an explicit device
(None = the first CUDA card), sharing one coalescer on one card.
"""
from autoscaler_tpu_torch.gym.env import (
    FleetEstimatorClient,
    GymError,
    PolicyGymEnv,
    RolloutResult,
)
from autoscaler_tpu_torch.gym.ledger import (
    BASELINE_ID,
    SCHEMA,
    dump_jsonl,
    load_jsonl,
    record_line,
    stable_json,
    summarize,
    validate_records,
)
from autoscaler_tpu_torch.gym.policy import (
    DEFAULT_POLICY,
    KNOB_SPACE,
    KNOBS,
    PolicyError,
    PolicySpec,
)
from autoscaler_tpu_torch.loadgen.suite import SuiteSpec, is_suite_doc
from autoscaler_tpu_torch.gym.tune import (
    PolicyRng,
    PopulationTuner,
    TuneConfig,
    TuneResult,
    tune_suite,
)

__all__ = [
    "BASELINE_ID",
    "DEFAULT_POLICY",
    "FleetEstimatorClient",
    "GymError",
    "KNOBS",
    "KNOB_SPACE",
    "PolicyError",
    "PolicyGymEnv",
    "PolicyRng",
    "PolicySpec",
    "PopulationTuner",
    "RolloutResult",
    "SCHEMA",
    "SuiteSpec",
    "TuneConfig",
    "TuneResult",
    "dump_jsonl",
    "is_suite_doc",
    "load_jsonl",
    "record_line",
    "stable_json",
    "summarize",
    "tune_suite",
    "validate_records",
]
