"""PolicyGymEnv: a gym-style reset/step/rollout wrapper over the REAL
loadgen ScenarioDriver.

The env does not reimplement anything: ``step()`` drives the exact
``ScenarioDriver.tick_once`` body ``run()`` loops over (loadgen/driver.py
exposes the tick loop for precisely this), on the driver's simulated
clock. Rollout-vs-direct decision parity is therefore structural — the
identity policy's decision log is byte-identical to ``run_scenario``'s
(tests/test_torch_gym.py locks it).

The *action* is a typed :class:`PolicySpec` (gym/policy.py), applied at
episode start through the AutoscalingOptions override seam (the ``--set``
machinery): its overrides merge into a copy of the scenario spec's
``options`` and the driver's schema gate validates them. Mid-episode
policy changes are rejected loudly — half the knob space (expander
strategy, breaker cooldowns) is consumed at construction, and silently
half-applying a policy would score a candidate nobody proposed.

Reward: the NEGATION of the scorer's per-tick objective contribution
(``loadgen.score.tick_objective``), so Σ step rewards ≈ −(the report's
``objective.weighted_total``) — the gym and the human report read the same
number by construction.

Fleet coalescing (Podracer batching): pass a shared ``FleetCoalescer`` and
every rollout's estimator routes its plain batched dispatches through the
coalescer's admission queue (estimator/binpacking.py ``fleet_client``
seam) — concurrent candidate rollouts then coalesce their estimator calls
into shared mesh dispatches. Answers are certified batch-invariant (the
fleet's fairness property), so scores are identical with or without the
coalescer; the coalescer buys dispatch amortization, never different
decisions.

The port of ``autoscaler_tpu/gym/env.py``: each episode's driver runs on
``device`` (None = the first CUDA card; ``"cpu"`` for the host).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from autoscaler_tpu_torch.device import resolve_device
from autoscaler_tpu_torch.gym.policy import DEFAULT_POLICY, PolicyError, PolicySpec
from autoscaler_tpu_torch.loadgen.score import (
    DEFAULT_WEIGHTS,
    ObjectiveWeights,
    build_report,
    tick_objective,
)
from autoscaler_tpu_torch.loadgen.spec import ScenarioSpec


class GymError(RuntimeError):
    """Env protocol misuse (step before reset, mid-episode policy swap)."""


@dataclass
class RolloutResult:
    """One full episode's verdict: the score the tuner ranks on plus the
    artifacts the parity tests byte-compare."""

    scenario: str
    seed: int
    policy: PolicySpec
    objective: float                 # the scorer's weighted_total (minimize)
    score: float                     # -objective (maximize; ledger column)
    report: Dict[str, Any] = field(default_factory=dict)
    decision_log: List[Dict[str, Any]] = field(default_factory=list)
    step_rewards: List[float] = field(default_factory=list)


class FleetEstimatorClient:
    """The estimator-side adapter of the shared coalescer: turns one plain
    packed estimate dispatch into a FleetRequest ticket and blocks for the
    demuxed answer. Lives here (not in fleet/) because the tenant identity
    and the blocking-rollout semantics are gym concerns."""

    def __init__(self, coalescer, tenant_id: str, timeout_s: float = 60.0):
        self.coalescer = coalescer
        self.tenant_id = tenant_id
        self.timeout_s = float(timeout_s)

    def estimate_groups(self, req, masks, allocs, caps, max_nodes: int):
        """[P,R]/[G,P]/[G,R]/[G] packed operands → (counts [G], scheduled
        [G,P]) numpy, via one coalesced (possibly co-batched) dispatch."""
        from autoscaler_tpu_torch.fleet.coalescer import FleetRequest

        ticket = self.coalescer.submit(FleetRequest(
            tenant_id=self.tenant_id,
            pod_req=req,
            pod_masks=masks,
            template_allocs=allocs,
            node_caps=caps,
            max_nodes=int(max_nodes),
        ))
        answer = ticket.result(timeout=self.timeout_s)
        return answer.node_counts, answer.scheduled


class PolicyGymEnv:
    """reset/step/rollout over one loadgen scenario.

    Episodes are deterministic: same (seed, policy) → same observation and
    reward streams, byte-identical decision logs (the loadgen contract)."""

    def __init__(
        self,
        spec: ScenarioSpec,
        weights: ObjectiveWeights = DEFAULT_WEIGHTS,
        coalescer=None,
        rollout_timeout_s: float = 60.0,
        device=None,
    ):
        if spec.fleet is not None:
            raise GymError(
                "PolicyGymEnv drives the control loop; fleet scenarios "
                "have no policy knobs to tune"
            )
        self.spec = spec
        self.weights = weights
        self.coalescer = coalescer
        self.rollout_timeout_s = rollout_timeout_s
        self.device = resolve_device(device)
        self._driver = None
        self._policy: PolicySpec = DEFAULT_POLICY
        self._seed: int = spec.seed
        self._tick = 0

    # -- the gym protocol ------------------------------------------------------
    def reset(
        self,
        seed: Optional[int] = None,
        policy: Optional[PolicySpec] = None,
    ) -> Dict[str, Any]:
        """Start a fresh episode: rebuild the driver from a copy of the
        scenario spec with the policy's overrides merged into ``options``
        (the sanctioned --set seam; out-of-range knobs raise PolicyError
        here, schema mismatches raise SpecError in the driver)."""
        from autoscaler_tpu_torch.loadgen.driver import ScenarioDriver

        policy = policy if policy is not None else DEFAULT_POLICY
        policy.validate()
        self._seed = self.spec.seed if seed is None else int(seed)
        self._policy = policy
        episode = ScenarioSpec.from_dict(self.spec.to_dict())  # exact copy
        episode.seed = self._seed
        episode.options = dict(episode.options)
        episode.options.update(policy.to_overrides())
        self._driver = ScenarioDriver(episode, device=self.device)
        if self.coalescer is not None:
            est = self._driver.autoscaler.scale_up_orchestrator.estimator
            est.fleet_client = FleetEstimatorClient(
                self.coalescer,
                tenant_id=f"gym:{episode.name}:{self._seed}",
                timeout_s=self.rollout_timeout_s,
            )
        self._driver.begin()
        self._tick = 0
        return self._observe_initial()

    def step(self, action: Optional[PolicySpec] = None):
        """Advance one scan interval → (observation, reward, done, info).

        ``action`` must be the episode's policy (or None): policies bind at
        episode start through the options seam, so a first-step action
        rebinds by rebuilding the driver, and a MID-episode change raises
        — half the knobs are construction-time and a silent partial apply
        would be a lie."""
        if self._driver is None:
            raise GymError("step() before reset()")
        if self._tick >= self.spec.ticks:
            # stepping past done would silently extend the episode beyond
            # the scenario (extra ticks, extra reward, a decision log
            # longer than the spec declares — breaking rollout-vs-direct
            # parity); fail loudly like every other protocol misuse
            raise GymError(
                f"episode is done (tick {self._tick} == spec.ticks); "
                "reset() to start a new one"
            )
        if action is not None and action != self._policy:
            if self._tick == 0:
                self.reset(seed=self._seed, policy=action)
            else:
                raise PolicyError(
                    "mid-episode policy change: knobs like the expander "
                    "and breaker cooldowns bind at episode start (the "
                    "AutoscalingOptions seam) — reset() to change policy"
                )
        rec = self._driver.tick_once(self._tick)
        self._tick += 1
        reward = -tick_objective(
            rec, self.spec.tick_interval_s, self.weights
        )
        done = self._tick >= self.spec.ticks
        obs = {
            "tick": rec.tick,
            "pending": rec.pending_after,
            "nodes_ready": rec.nodes_ready,
            "nodes_total": rec.nodes_total,
            "demand_nodes": rec.demand_nodes,
            "degraded": bool(rec.degraded),
        }
        return obs, reward, done, {"record": rec.to_dict()}

    def rollout(
        self,
        policy: Optional[PolicySpec] = None,
        seed: Optional[int] = None,
    ) -> RolloutResult:
        """One full episode under ``policy`` → the tuner's scoring unit."""
        self.reset(seed=seed, policy=policy)
        rewards: List[float] = []
        done = self._tick >= self.spec.ticks
        while not done:
            _, reward, done, _ = self.step()
            rewards.append(reward)
        result = self._driver.finish()
        report = build_report(result, weights=self.weights)
        objective = float(report["objective"]["weighted_total"])
        return RolloutResult(
            scenario=self.spec.name,
            seed=self._seed,
            policy=self._policy,
            objective=objective,
            score=round(-objective, 6),
            report=report,
            decision_log=result.decision_log(),
            step_rewards=rewards,
        )

    # -- helpers ---------------------------------------------------------------
    def _observe_initial(self) -> Dict[str, Any]:
        api = self._driver.api
        return {
            "tick": -1,     # before the first scan interval
            "pending": sum(1 for p in api.list_pods() if not p.node_name),
            "nodes_ready": sum(1 for n in api.list_nodes() if n.ready),
            "nodes_total": len(api.nodes),
            "demand_nodes": 0,
            "degraded": False,
        }
