#!/usr/bin/env python3
"""Runs the PyTorch port's main paths, the scale-up estimate with and
without dynamic inter-pod affinity and hard topology spread, the cluster
snapshot's predicate fit, the scale-up and scale-down halves of a
reconcile tick, the reconcile loop bound to a Kubernetes API and a cloud
API over HTTP, the loop's preemption pass, the scenario what-if and the
fleet's coalesced estimates, the scenario engine (the load generator's
drills, the fleet drill, the policy gym, per-tick profiler sessions and
the canned scenarios), and the Vertical Pod Autoscaler's recommender and updater, on one CUDA
card through its hand-written kernels, and holds every kernel against its
plain PyTorch version.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and PyTorch's name;
2. build: each CUDA source compiled with nvcc, all at once; each ptxas
   report (registers, static shared memory, spills);
3. the main paths, each with every launch and route count set to 0 just
   before it and read just after; every estimate walks the kernel ladder
   (``estimator/ladder.py``), and a path fails if, on the card, a rung
   attempt faults, a dispatch is served below the cuda rung for any reason
   but the shape gates (smem, spread_width) or dedup routing, a dispatch
   is forced, a breaker changes state, or the ``estimator`` logger warns
   (``tools/ladder_probe.LadderWatch``, over the counters of one
   ``AutoscalerMetrics`` that every estimator on the card counts on):
   a. the repo's headline estimate (bench.py's workload: 100k pending pods
      × 500 node groups, 1000-node cap, 6 resource axes) through
      ``ffd_binpack_groups_cuda`` with integral requests (SWAR kernel K2)
      and with fractional memory (f32 kernel K1);
   b. the object-level estimator on a 30k-pod pending burst × 100 node-group
      templates and the least-waste expander's choice (K2);
   c. a replicated-pods burst (the run-compressed route, no kernel);
   d. the affinity workload (benchmarks/affinity_bench.py's default: 20k
      pods × 100 groups × 50 terms, 1000-node cap) through
      ``ffd_binpack_groups_affinity_cuda`` (K3);
   e. the object-level spread world (benchmarks/spread_bench.py's default:
      20k unique pods × 16 zoned templates, 10% hostname anti-affinity, 5%
      zone DoNotSchedule spread) through ``estimate_many`` and least-waste
      (K3), and the same world with the spread over the hostname key;
   f. a replicated affinity world (30k pods of 300 deployments, one in ten
      with hostname anti-affinity on its own app; the runs-affinity route,
      no kernel);
   g. the tiled fit (benchmarks/fit_bench.py's operands: 100k pods × 15k
      nodes × 6 resources, 40 × 24 classes, 1.5 G pairs) through
      ``fit_reduce_cuda`` (K4);
   h. the snapshot probe: a ``ClusterSnapshot`` on the card holding a
      15k-node, 105k-pod world (one pod in seven pending, hostname
      anti-affinity on 1% of them, a host-port DaemonSet on 5k nodes) is
      packed into factored ``SnapshotTensors`` and probed by
      ``DebuggingSnapshotter.capture`` (``fits_any_node``) and
      ``first_fit_node``, each through ``fit_reduce_exact`` (K4 plus the
      exact patch of the exception-row and single-cell pods, whose true
      rows go through K4's rows entry);
   i. the plain route's shape gate: a 300-pod world with 7 f32 planes
      (fractional memory, four host ports) at a scan cap of 8192 through
      ``estimate_many``, whose carry exceeds a block's shared memory, so
      the cuda rung's gate answers smem and the torch loop serves it (route
      torch_scan), and the same world with 6 planes, which launches K1
      (route cuda);
   j. the scale-up tick: the snapshot world of (h) plus (b)'s 30k burst in
      a ``ClusterSnapshot`` on the card, run through ``run_once``'s
      sequence (static_autoscaler.py:629-631, :712): ``fork``,
      ``FilterOutSchedulablePodListProcessor.process`` (the hinting
      simulator's ``greedy_schedule`` loop on the card), ``revert``, then
      ``ScaleUpOrchestrator.scale_up`` over what is still pending, on a
      ``TestCloudProvider`` whose 100 groups are (b)'s templates with the
      world's zone key beside "zone" (min 0, max 1000, target 0),
      least-waste with seeded ties; the estimate must launch the kernel
      its route names (K1/K2 on ``ffd_scan``, K3 on ``ffd_scan_aff``);
   k. the same tick with one burst pod in twenty that carries no selector
      and no toleration given a zone DoNotSchedule spread (maxSkew 1) on
      one of the world's first 24 apps: the spread context over the placed
      pods, the gate and commit in the greedy loop, and the orchestrator's
      cluster context into K3 with at most 32 spread terms;
   l. the tick sequence over one ``IncrementalPacker`` carried across
      ticks (``tools/tick_probe.run_sequence``): tick 1 on (j)'s listing
      through ``ClusterSnapshot(packer=...)`` (the packer's first update, a
      full build; its result must equal (j)'s), then the world one scan
      interval after the burst (the pods tick 1 filtered bound to their
      nodes, the nodes its IncreaseSize asked for up, 1% of the running
      pods gone, 1000 new pending pods) and tick 2, then the steady state
      (tick 2's filtered pods bound, 200 gone, 200 new) and tick 3; ticks
      2 and 3 must be incremental (no full pack) and dirty no more pod rows
      than twice the pods their churn changed;
   m. the scale-down half of two reconcile loops
      (``tools/scaledown_probe.run_scale_down``, static_autoscaler.py:
      788-880) on (h)'s world after a scale-in (every placed pod of apps
      0-99 gone), on a ``TestCloudProvider`` with one group a node shape and
      a ``FakeClusterAPI`` of the listing, at ``AutoscalingOptions()``: at
      t = 0 ``update_cluster_state`` over every node (utilization on the
      card, empty detection, the drain rules, one removal dispatch of 30
      candidates) and ``nodes_to_delete`` (nothing yet: no node unneeded
      long enough); at t = 601 the same, then
      ``ScaleDownActuator.start_deletion`` (taints, deletions);
   n. the same on the listing whose placed pods of apps 100-123 carry a
      zone DoNotSchedule spread, every eligible non-empty node simulated in
      one ``removal_feasibility_spread`` dispatch (thousands of lanes) and
      ten drains validated by ``joint_removal_feasibility_spread``, then
      evicted and deleted. The scale-down half runs no hand kernel.
   o. the reconcile loop (``tools/loop_probe.run_loop_ticks``): one
      ``StaticAutoscaler`` on the card (``device=None``) over (m)'s listing
      with (b)'s burst pending and (j)'s groups beside (m)'s, on a
      ``FakeClusterAPI`` and a ``TestCloudProvider``, at
      ``AutoscalingOptions()`` with a journal probe every tick and a seeded
      expander: three ``run_once`` ticks at t = 0, 601 and 1202 s, a churn
      between them (filtered pods bound, the requested nodes up with the
      leftover pods on them, 1000 new pods before tick 3, one in twenty
      zone-spread). Tick 1 scales up through K1/K2, tick 2 deletes empty
      nodes, tick 3's estimate takes K3, and every tick's journal probe
      runs ``fits_any_node`` through K4 and finds no drift; each tick's
      summary, host split by the tracer's spans, pack, journal capture,
      encode and probe times are printed;
   p. an ``ObservabilityServer`` (profiling on) on (o)'s autoscaler:
      every endpoint answers 200 with a body of (o)'s ticks, ``/perfz``
      with one perf record a tick;
   q. ``python -m autoscaler_tpu_torch.main --provider=test
      --max-iterations=2 --scan-interval=0 --address=:0`` in a subprocess on
      the card exits 0;
   r. the bound reconcile loop (``tools/bound_loop.run_bound_ticks``) at
      (4l)'s tenth of (o)'s world (its full size is
      ``python3 -m autoscaler_tpu_torch.tools.bound_loop``'s run; chip_smoke
      cut it to a tenth to stay inside its time), served as JSON by the fake
      Kubernetes API of
      ``tools/binding_probe`` (a child process), every group a
      MachineDeployment with its size and scale-from-zero annotations, every
      node annotated with its Machine; ``KubeRestClient`` →
      ``KubeClusterAPI(watch=True)`` → ``build_clusterapi_provider`` → a
      ``StaticAutoscaler`` on the card, expander ``priority,least-waste``
      on a live priority ConfigMap, under a ``LeaderElector`` on a
      ``KubeLease``; three ticks once the watch caches are synced, (o)'s
      churn pushed as watch events between them. K2, K3, K4 and its rows
      entry launch, and the
      fake API saw the ``/scale`` PUTs, taints, evictions and node DELETEs
      the decisions imply, one status ConfigMap write a tick and one Lease
      holder; the first list's split (HTTP read, ``json.loads``,
      ``convert``), each tick's lists, watch apply and host split are
      printed;
   s. ``python -m autoscaler_tpu_torch.main --provider=gce --kube-api=...
      --leader-elect --expander=priority,price
      --expander-priority-config-map=...`` in a subprocess on the card at
      (4l)'s size, against the fake kube and Compute APIs (one MIG a node
      shape, five burst MIGs, one a ct5lp TPU pool): it exits 0, took the
      Lease, resized a MIG, wrote the status ConfigMap, and its estimate and
      journal probes launched kernels (counted in the subprocess);
   s2. the port as it is installed and started
      (``tools/install_probe``): (a) ``python -m
      autoscaler_tpu_torch.ops.build_kernels --out <fresh dir under
      build/>`` in a subprocess builds every library (the four CUDA sources
      and the native rung's), each one's registers and spills and ``ldd``'s
      view of K4's library (nothing of the CUDA toolkit but the driver)
      printed; (b) an installed copy of the package outside the checkout,
      holding only what the wheel ships (the ``.py`` files and
      ``pyproject.toml``'s package-data globs), runs (s)'s command line
      with ``--compile-cache-dir`` on (a)'s directory: it exits 0, starts
      no compiler, writes nothing into the copy, resizes as (s) did, and its
      estimate and journal probes launch K1/K2 and K4 (counted in the
      subprocess, on the kernels line); (c) the same on an empty directory:
      main's start builds the loop's three libraries, one compiler each,
      and logs it before tick 0, with (b)'s decisions; each run's start-up
      seconds are printed with the card's name and power limit;
   t. the preemption storm (``tools/preempt_probe.run_preempt_ticks``) at
      (4l)'s tenth (its full size is ``tools/preempt_probe``'s run; cut to
      a tenth as (r) is): (o)'s world and churn with priorities (apps 100-199's placed pods at
      0, the rest of the listing at 1000, the burst, a wave of 9000
      15-core pods and tick 3's arrivals at 10000, one in five at
      ``preemptionPolicy: Never``), three ``run_once`` ticks with
      ``--preemption-enabled``, a churn weight of 1.0 and the journal on:
      each tick's pass (``estimate_preemption``: the torch loop of
      ``ops/preempt.py`` on the card, route ``torch_preempt``; no hand
      kernel) plans admissions and evictions before the scale-up and
      evicts after it the victims of the pods it leaves uncovered; K1/K2
      launch in tick 1 and K4 in the journal probes; each tick's eligible,
      admitted, planned and evicted counts and ``preemptPlan`` span are
      printed, then ``python -m autoscaler_tpu_torch.journal replay`` over
      the ticks' journal and decision ledger runs on the card and must
      find no divergence;
   u. scenario batching (``tools/fleet_probe``): (a)'s operands under
      BASELINE config 5's 8 spot-pricing scenarios (shared allocs, base
      prices uniform in 0.5-3.0, spot discount 0.7, revocation 0.3, seed 0)
      through ``whatif_best_options`` on ``make_mesh()`` (1x1 on one card)
      with ``ffd_binpack_groups_cuda``, one K2 launch a scenario: every
      scenario's counts equal (a)'s K2 counts, the costs, best groups and
      best costs the host's f32 recomputation; ``ScenarioStrategy`` over
      the expansion options of (b)'s estimate (K1/K2 behind the shared
      memory gate), its choice held the same way; and
      ``sharded_affinity_estimate(use_pallas=True)`` on a 1-device group
      mesh over (d)'s operands, one K3 launch equal to (d)'s;
   v. the fleet: a ``FleetCoalescer`` (buckets 1024x32x8 and 4096x64x8, 8
      scenario slots, prewarmed) on the card serves 16 tenants of
      bench.py --fleet's form at real widths (512-4096 pods, 8-64 groups,
      integral cpu and memory, caps 1-1000, every second one priced) and
      one of 6000 pods x 100 groups (an ad-hoc bucket) in one flush: every
      batch one K1/K2 launch over its S·G groups
      (``ffd_binpack_scenarios_cuda``), every ticket on rung cuda's route,
      every answer byte-equal to the tenant's solo dispatch, every what-if
      best group the host's f64 argmin; batched and sequential
      tenant-requests/s as bench.py --fleet reports them; then the
      estimator's fleet lane: two estimators on the card share one started
      coalescer (5 ms window), each estimating a 3 000-pod slice of (b)'s
      burst x (b)'s templates from its own thread, each equal to its solo
      estimate, on route fleet_coalesced;
   w. Cluster Autoscaler's scalability drill at full size through the load
      generator's ``run_scenario`` (``tools/drill_probe``): one node group
      (4 000 m, 16 384 MiB, 110 pods; 10 to 1 000 nodes), 21 000 pods of
      130 m / 512 MiB at tick 0 and 9 000 more at tick 1, all bound at 30
      a node; the 9 000 complete at tick 4, and 10 minutes later the 300
      emptied nodes go, 10 a tick (45 one-minute ticks); the latency
      percentiles, node counts, deletions, the ticks' and the binder's
      wall times and each tick's kernel routes are printed;
   x. the fleet drill (``loadgen/fleetdrive``) over six tenants in the
      shape of the JAX package's canned ``fleet_tenants`` scenario, 8
      rounds: every answer equal to its solo dispatch (``all_match``);
   y. the profiler: two ticks of the drill's world (a scale-up of 64 pods
      of distinct sizes through K2, a scale-down of 10 emptied nodes; the
      journal's probe through K4 each tick) with ``jax_profiler_dir`` set,
      against the same run unprofiled: the decisions equal, each tick's
      torch.profiler session a Chrome trace naming its step, its kernels'
      ranges and the estimator's cuda range, with the kernels' launch
      correlation counted;
   z. the Vertical Pod Autoscaler (``tools/vpa_probe.run_vpa``) over (h)'s
      cluster at (4l)'s tenth (1 500 nodes, 10 000 pods; its full size is
      ``python3 -m autoscaler_tpu_torch.tools.vpa_probe``'s run, cut as (r)
      is: a pass over 100 000 pods is ~15 s of host Python), each of its
      300 apps in a namespace of its own under one VPA (Auto), its
      histogram banks on the card: a warm start from 8 days of hourly
      history for all 10 000 pods (``replay_history``: 1.92 M CPU samples
      and the memory peaks), then five live passes a minute apart over
      every pod, each a ``VpaRunner.run_once`` (scrape,
      six percentiles a bank, status writes, checkpoints, evictions with
      the evicted pods readmitted at their VPA's target) on an in-memory
      API; every sample batch goes through K5, the ordered scatter-add
      (``ops/histogram.ordered_scatter_add``, ``csrc/histogram.cu``).
   Every kernel of the paths must have launched;
4. each kernel at its headline shape against its plain version on the same
   card tensors, exactly: K1/K2 on all 500 groups, K3 on its three
   launches (all 100 groups of the affinity workload, all 16 of each
   spread world), each with its launch geometry, chain floor, the search
   counts of the data and the bound recounted from them; the main paths'
   results against the plain versions' results; the
   estimator's results and choices against the same calls on the CPU (the
   CPU takes a stride sample of the templates for the dynamic worlds:
   each group's result depends on its own template only; the CPU's
   estimator takes its own route, the torch loops, so 4c, 4d and 4g-4h
   run in ``CPU_WORKERS`` worker processes started once the worlds exist,
   while the card works, and each result is read where its check
   stands); the gate worlds against the CPU; K4 on all
   100k pods of the tiled fit and on the probe's two launches, and its
   rows entry on the probe's special rows, with K4's launch geometry,
   registers and SASS instructions a pair (4e); the probe's
   ``fit_reduce_exact`` on all 131 072 pod rows against a reduction of
   ``dense_sched()`` rows chunked by pods, and its exact patch timed in
   parts (4f); both ticks again on a ``ClusterSnapshot``
   on the CPU of the same objects: every filtered key and assignment, the
   snapshot after the revert, the whole ScaleUpResult and the provider's
   target sizes equal (4g); the tick sequence: tick 2's tensors against a
   full pack of its listing on the card by pod key and node name, and the
   sequence replayed on the CPU through a packer of its own, ticks 2 and 3
   whole and equal (4h); the resident arena: a second packer with a
   ``DeviceArena`` on the card replays the three listings, serves tensors
   equal bit for bit to the first packer's, seeds on tick 1 alone and
   never rolls back, each apply's span on the card by CUDA events (4i);
   3m repeated whole on the CPU, both loops and the actuation field for
   field (the eligible names, every utilization bit for bit, the empty,
   simulated and unneeded names, every ``NodeToRemove`` with its
   destinations, the unremovable reasons, the ``ActuationResult`` and the
   target sizes) (4j); 256 seeded lanes of 3n's removal dispatch repeated
   on the CPU from the same operands, and its joint pass whole (4k); (o)'s
   sequence at a tenth of its size (1 500 nodes, a 3 000-pod burst, 100
   arrivals) on the card and again on the CPU, every tick's RunOnceResult,
   target sizes and calls, nodes, pods, taints, evictions, ConfigMaps and
   decision, journal and SLO lines equal (4l); every kernel launch of
   (o) (K2 and K3 in its estimates, K4 and its rows entry in its journal
   probes and the debugger's capture), captured with copies of its
   operands and outputs, against its plain version on those operands,
   every field exact (4m); (r)'s sequence at (4l)'s size and (s)'s gce
   world in this process, each on the card and again on the CPU against
   fresh fake servers: each of (r)'s ticks decides as (4l)'s card ticks
   did (the scale-up by group, the nodes deleted, the unneeded and
   unremovable counts), every RunOnceResult, target size and recorded
   write equal (the Lease's times and the Machines' deletion marks
   canonicalised), and the gce world's resize and deleteInstances
   requests equal (4n); (t)'s ticks again on the CPU (in a worker begun
   at 3t): every tick's state, preemption summary and the journal's
   replay verdicts equal (4o); the preemption loop
   against its plain version on the card and the serial oracle on
   bench.py's 24 storm worlds and three worlds of 240 pods × 50 nodes with
   memory in bytes, every decision equal (4p); (v)'s batched launches
   against the kernel's plain version on their captured operands,
   ``ffd_binpack_scenarios_cuda`` against its plain version and the serial
   oracle on bench.py --fleet's 32 x 8 x 8 worlds (padded zero slots,
   cap-0 groups, a fractional tenant that turns the batch to K1), a fleet
   of 8 tenants at the 1024x32x8 bucket on the card and on the CPU (in a
   worker begun at 3v) with equal answers, decision-ledger record and
   fleet metric lines, and ``sharded_scaledown_step`` on a 1-device
   candidate mesh over (m)'s candidates against (m)'s passes (4q); (w)'s
   drill at a tenth (100 nodes, 3 000 pods) on the card and on the CPU
   (in a worker begun at 3w), the decision logs and score reports (wall
   fields aside) byte-equal (4r); ``python -m autoscaler_tpu_torch.gym
   tune`` over a two-scenario suite at (4r)'s size on the card and on the
   CPU (in a worker begun at 3w), the tuning ledgers equal (4s); (z)'s run
   again on the CPU (in a worker begun at 3w), every recommendation,
   status write, checkpoint and eviction equal, K5 against its plain
   version on each of the warm start's four batches bit for bit and on
   five adversarial worlds (one cell taking 50 000 pairs, shuffled pairs,
   the memory bank's signed replacements, runs whose partial sums cross
   below 2^-126, int64 indices with pads past 2^31), K5's whole call, its
   grouping and its chains (torch.profiler), a feed's four targets,
   ``index_add_`` and the one-cell world of the largest batch's pairs on
   the card, timed on the warm start's batches (``tools/k5_bench.measure``)
   beside a bound with a chain term, and the admission webhook over (z)'s
   recommendations over HTTP, and over HTTPS where ``cryptography``
   imports (the script prints which) (4t); the static checker and its
   determinism sanitizer (``tools/analysis_probe``): graftlint over the
   port's whole tree with no baseline, in a CPU worker begun at 3w, with
   zero findings; the JAX package's ``kernel_fault_ladder`` scenario built
   in code (the estimator's cuda and torch rungs faulted at tick 2,
   cleared at tick 10, a burst of 64 pods of distinct sizes at ticks 1
   and 14, so K2 launches) through the loadgen CLI on the card: ``run
   --sanitize --trace``, then ``replay --sanitize`` and a plain
   ``replay``, no ambient read trapped, the sanitized replay's report and
   log equal to the run's (walls aside), its K2 launches counted on the
   kernels line as a path's; and the kernel contracts' ground truth: each entry that
   declares ``KERNEL_CONTRACTS`` (K1/K2 through ``ffd_binpack_groups_cuda``,
   ``ffd_binpack_scenarios_cuda``, ``ffd_scan_f32`` and ``ffd_scan_swar``,
   K3 through ``ffd_binpack_groups_affinity_cuda``, K4, its rows entry and
   K5) on 10 seeded worlds each, well-formed and perturbed, the contract's
   verdict equal to the launch's success and every accepted launch bit-equal
   to the entry's plain version (4u);
5. the estimator's services: (a) each of (o)'s perf records (residency
   pools, the arena's delta rows, dispatches by route) and the ladder's
   proof over every path so far: no fault attempt, no breaker transition;
   (b) a fault walk on the card at (4l)'s size: three faults armed on the
   cuda rung of a reconcile loop's estimator through ``fault_hook``; each
   faulted estimate raises (on the card the kernels have no fallback) and
   is counted and logged, the third opens the breaker, ``/health-check``
   reads degraded and the next estimate raises too; past the cooldown one
   half-open probe launches the kernel, serves the first decisions and
   closes the breaker; (c) the native rung (its library built from
   ``autoscaler_tpu_torch/csrc/ffd_serial.cpp`` at first use, timed) on
   every group of (4l)'s burst and the Python rung on every 50th, each
   served by an estimator on the CPU with the rungs above it faulted,
   against the cuda rung's decisions; (d) the fleet's fault walk on the
   card (``fleet_probe.fault_walk``): faults injected on the coalescer's
   cuda rung fail their batches' tickets with the error and no oracle
   serves; the breaker opens, a batch while it is open fails too, and
   past the cooldown on the injected clock a probe serves and closes it;
   (e) a ``kernel_fault`` scenario on the cuda rung, then
   ``clear_faults``, on (4r)'s node group with pods of distinct sizes
   (``drill_probe.fault_doc``): each faulted tick's run_once raises and the
   driver records the typed error, nothing serves below the cuda rung,
   and after the clear a half-open probe closes the breaker and the
   decisions flow; then (4v) the canned scenarios (``tools/canned``: the
   fourteen documents of the JAX package's ``benchmarks/scenarios/`` built
   in code, and ``gym_suite``'s five as plain scenarios) each once on the
   card through the port's driver and once on the CPU in a worker begun
   after (4b): with no fault on a device rung, the decision log (a fleet's
   round ledger) byte-equal and the score report equal apart from its
   walls, the serving rung named as the CPU names it; the four that fault
   one held to the design ``tools/canned`` writes down (the ticks before
   the first fault as on the CPU; while the card's rungs are faulted
   nothing launches and nothing is served, on the host rungs neither, and
   a tick whose estimate raised records the typed error; no host rung
   serves after the clear, and a card rung serves again only after a
   half-open probe closed its breaker; the fleet's torch-rung fault never
   engages, every ticket answered on the batched rung); one
   line a scenario (ticks, card and CPU seconds, routes, launches), the
   launches counted from 0 and added to the kernels line as a path's;
6. timings with CUDA events, each run queued behind ~10 ms of a spinning
   card so that they time the card and not the host's launches: each
   kernel alone, its whole entry call, and the plain version; K3 on the
   zone and hostname spread worlds; K4 on the probe's operands, the whole
   ``fit_reduce_exact`` there and its exact patch in parts; each tick's
   split by the host clock (pack, spread context, greedy loop, commit
   loop, scale_up with its estimate, kernel and expander; the three ticks
   of the sequence too), the greedy
   loop's span on the card (CUDA events around it), its launches, kernels
   and device time a step (torch.profiler on 100 steps, which run
   eagerly, less a run of one step), and the card-busy time and idle
   share derived from them; each scale-down loop's split by the host
   clock (pack, eligibility with the utilization's span on the card,
   empty detection, the drain rules, the removal dispatch's span, the
   joint validation, actuation) and the dispatch's lanes, slots stepped,
   lane chunk, launches and device time a step (torch.profiler) and idle
   share.

The last two lines of standard output are the kernels line (one JSON
object: the hand kernels under "kernels", and under "torch_preempt" the
preemption loop's dispatches in 3t and its largest difference from the
plain version and the oracle in 4p) and ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repo, it exits non-zero and prints nothing on
standard output.
"""
from __future__ import annotations

import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

# The card's peak rates (NVIDIA H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12   # non-tensor f32; also used for the int32 ops, a lower bound

BURST_PODS = 30_000      # BASELINE.md's 30k-pod burst (scalability_tests.md:30-34)
BURST_TEMPLATES = 100
REPLICATED_PODS = 30_000
REPLICATED_CONTROLLERS = 300
REPS = 3
CPU_TEMPLATE_STRIDE = 2      # spread worlds: every second template on the CPU (8 of 16)
CPU_RUNS_TEMPLATE_STRIDE = 20  # replicated affinity world: 5 of 100 templates
HOST_LEAD_CYCLES = 20_000_000  # ~10 ms of the card's clock before each timing
GATE_PODS = 300          # the plain-route gate worlds
GATE_MAX_NODES = 5000    # a scan cap of 8192
HOSTNAME_KEY = "kubernetes.io/hostname"
CPU_WORKERS = 4          # worker processes for the CPU's side of 4c, 4d, 4g and 4h
CPU_WORKER_THREADS = 2   # torch's threads in each
CPU_WAIT_S = 600         # the longest wait for one worker's result

_POOL = None             # the CPU workers, stopped when the script ends


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# K3's operations for each unit of work its plain version counts: a node
# fit test is R compares; a term gate on an open node that fits is ~16 int
# ops a term plane with a bit set (two domain blends, three violation
# terms); a hostname spread gate is an add, a subtract and a compare; a
# hostname-minimum read is one min. The per-step group scalars (new_ok,
# group-level spread) are left out, which keeps the bound a lower bound.
K3_OPS = {"gate_plane_tests": 16, "host_gate_tests": 3, "open_min_nodes": 1}
# The kernels' search, as their plain versions count it: blocks tested
# against their summaries, candidate blocks searched, rounds (one barrier
# each), placements (one barrier each), and the node tests of a plain scan;
# the bound counts the fewer of the two searches' fit tests
SEARCH_COUNTS = ("summary_tests", "candidate_blocks", "rounds", "placements", "node_tests")
NODE_BLOCK = 32          # nodes a block summary covers (ops/ffd_scan.py)


def fit_tests(stats: dict) -> int:
    """The node fit tests the data needs: a plain scan's, or the pruned
    search's summary tests and the node tests of its candidate blocks,
    whichever is fewer."""
    pruned = stats["summary_tests"] + NODE_BLOCK * stats["candidate_blocks"]
    return min(stats["node_tests"], pruned)


def k3_operations(stats: dict, R: int) -> int:
    return fit_tests(stats) * R + sum(stats[k] * w for k, w in K3_OPS.items())


def k3_work(stats: dict, R: int) -> str:
    return " + ".join(
        [f"min({stats['node_tests']} node tests, {stats['summary_tests']} summary tests "
         f"+ {NODE_BLOCK} x {stats['candidate_blocks']} candidate blocks) = "
         f"{fit_tests(stats)} fit tests x {R}"]
        + [f"{stats[k]} {k} x {w}" for k, w in K3_OPS.items()]
    )


def search_line(stats: dict, steps: int, P_pad: int) -> str:
    """The search counts a group step, and the busiest group's a step."""
    return (
        f"search over {steps} group steps: "
        + ", ".join(f"{stats[k]} {k} ({stats[k] / steps:.4f} a step)" for k in SEARCH_COUNTS)
        + "; the busiest group: "
        + ", ".join(f"{stats[f'max_group_{k}']} {k} ({stats[f'max_group_{k}'] / P_pad:.4f} a step)"
                    for k in SEARCH_COUNTS[1:4])
    )


def k4_registers(report: str) -> list:
    """'<kernel>: <registers line>' for each kernel of ptxas's report."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            short = re.search(r"\d(fit_reduce_(?:kernel|generic))ILi(\d+)E", m.group(1))
            gate = {"0": "class bits", "1": "class bytes", "2": "rows"}.get(short.group(2), "?") if short else "?"
            name = f"{short.group(1)}<{gate}>" if short else m.group(1)
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return out


# SASS opcodes issued on the ALU pipe (logic, compares, integer add and
# select); IMAD, FADD and the uniform datapath are not
ALU_OPS = ("LOP3", "FSETP", "ISETP", "PLOP3", "SEL", "IADD3", "VIADD", "SHF", "LEA", "POPC",
           "FLO", "BREV", "VIMNMX", "IMNMX", "FMNMX", "PRMT")


def k4_sass_loops(lib_path) -> dict:
    """{live resources: (instructions a pair, ALU instructions a pair)} of
    the class-bits kernel's inner loops, from ``cuobjdump -sass``: a loop is
    a backward branch whose body holds one predicated instruction a pair
    (the verdict's bit) besides the branch, shared-memory loads and, at NL
    live resources, NL FSETP a pair."""
    import os

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if "fit_reduce_kernelILi0E" not in func.split("\n", 1)[0]:
            continue
        rows = []
        for line in func.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9.]+)", line)
            if m:
                rows.append((int(m.group(1), 16), m.group(2), m.group(3), line))
        for addr, _, op, line in rows:
            target = re.search(r"BRA\s+.*?0x([0-9a-f]+)", line)
            if not op.startswith("BRA") or not target or int(target.group(1), 16) >= addr:
                continue
            body = [r for r in rows if int(target.group(1), 16) <= r[0] <= addr]
            pairs = sum(1 for r in body if r[1] and not r[2].startswith("BRA"))
            fsetp = sum(1 for r in body if r[2].startswith("FSETP"))
            if pairs < 8 or fsetp % pairs or not any(r[2].startswith("LDS") for r in body):
                continue
            nl = fsetp // pairs
            alu = sum(1 for r in body if r[2].split(".")[0] in ALU_OPS)
            if nl not in out or len(body) / pairs < out[nl][0]:
                out[nl] = (len(body) / pairs, alu / pairs)
    return out


def _cpu_worker_init(threads: int) -> None:
    import torch

    torch.set_num_threads(threads)


def cpu_estimate(pods, templates, max_nodes=None):
    """One ``estimate_many`` on the CPU, in a worker → (seconds, {group:
    (node count, [scheduled pod names])})."""
    from autoscaler_tpu_torch.estimator.binpacking import BinpackingNodeEstimator
    from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter

    limiter = ThresholdBasedEstimationLimiter(max_nodes=max_nodes) if max_nodes else None
    t0 = time.perf_counter()
    out = BinpackingNodeEstimator(limiter, device="cpu").estimate_many(pods, templates)
    return time.perf_counter() - t0, {
        g: (count, [p.name for p in sched]) for g, (count, sched) in out.items()}


def cpu_tick(world_nodes, world_pods, extra, templates):
    """One scale-up tick on the CPU (``tick_probe.run_tick``), in a worker
    → its ``tick_probe.tick_summary``."""
    from autoscaler_tpu_torch.tools import tick_probe

    return tick_probe.tick_summary(
        tick_probe.run_tick(world_nodes, world_pods, extra, templates, "cpu"))


def cpu_sequence(listings, templates):
    """The tick sequence's listings on the CPU through a packer of its own,
    in a worker → for tick 1, its packer update alone: (seconds, None);
    for each later tick, the whole tick: (seconds,
    ``tick_probe.tick_summary``)."""
    from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
    from autoscaler_tpu_torch.tools import tick_probe

    packer, out = IncrementalPacker(device="cpu"), []
    for k, (nodes_k, pods_k) in enumerate(listings):
        t0 = time.perf_counter()
        if k == 0:
            tick_probe.listing_snapshot(nodes_k, pods_k, "cpu", packer).tensors()
            out.append((time.perf_counter() - t0, None))
            continue
        rec = tick_probe.run_tick(nodes_k, pods_k, (), templates, "cpu", packer=packer)
        out.append((time.perf_counter() - t0, tick_probe.tick_summary(rec)))
    return out


def cpu_preempt(world):
    """3t's ticks at a tenth on the CPU (``tools/preempt_probe``), in a
    worker → (seconds, ``preempt_probe.tick_views`` on the CPU)."""
    from autoscaler_tpu_torch.tools import loop_probe, preempt_probe

    t0 = time.perf_counter()
    out = preempt_probe.run_preempt_ticks(*world, "cpu", arrive=loop_probe.ARRIVALS // 10,
                                          replayable=True)
    return time.perf_counter() - t0, preempt_probe.tick_views(out, "cpu")


def cpu_fleet():
    """4q's fleet (``tools/fleet_probe.fleet_view``) on the CPU, in a worker
    → (seconds, the view)."""
    from autoscaler_tpu_torch.tools import fleet_probe

    t0 = time.perf_counter()
    view = fleet_probe.fleet_view("cpu")
    return time.perf_counter() - t0, view


def cpu_drill():
    """4r's drill at a tenth on the CPU (``tools/drill_probe``), in a worker
    → (seconds, ``drill_probe.comparable``)."""
    from autoscaler_tpu_torch.tools import drill_probe

    result, seconds = drill_probe.run_drill(drill_probe.drill_doc(tenth=True), "cpu")
    return seconds, drill_probe.comparable(result)


def cpu_tune():
    """4s's tune on the CPU (``python -m autoscaler_tpu_torch.gym tune``
    over ``drill_probe.gym_suite_doc``), in a worker → (seconds, the
    tuning ledger's text)."""
    from autoscaler_tpu_torch.tools import drill_probe

    t0 = time.perf_counter()
    text = drill_probe.tune_ledger(drill_probe.gym_suite_doc(), "cpu")
    return time.perf_counter() - t0, text


def k5_worlds():
    """4t's adversarial worlds for K5, seeded CPU tensors (target, index,
    values): one cell taking 50 000 pairs (past a block's shared memory),
    shuffled pairs with zipf duplicates, the memory bank's signed
    replacements, runs whose partial sums cross below 2^-126, and int64
    indices whose pads lie past 2^31 and below 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(45)
    tiny = np.finfo(np.float32).tiny
    worlds = {}
    for label, N, K in (("one cell", 3, 50_000), ("shuffled", 1000, 200_000),
                        ("signed", 176 * 300, 200_000), ("subnormal", 64, 4000),
                        ("int64", 176 * 300, 200_000)):
        target = rng.standard_normal(N).astype(np.float32)
        values = (rng.standard_normal(K) * 10.0 ** rng.uniform(-4, 4, K)).astype(np.float32)
        if label == "one cell":
            index = np.full(K, 1)
        elif label == "shuffled":
            index = np.minimum(rng.zipf(1.2, K) - 1, N - 1)
        elif label == "signed":
            index = rng.integers(0, N, K)
            values = (2.0 ** rng.uniform(-3, 0, K)).astype(np.float32)
            swap = rng.random(K) < 0.4
            values[swap] *= -1
            index[1:][swap[1:]] = index[:-1][swap[1:]]
        elif label == "subnormal":
            index = rng.integers(0, N, K)
            values = (rng.integers(-6, 7, K) * 0.5 * tiny).astype(np.float32)
            target = (rng.integers(-2, 3, N) * 0.5 * tiny).astype(np.float32)
        else:
            index = rng.integers(0, N, K)
            pads = rng.random(K) < 0.01
            index[pads] = rng.choice([2**31, 2**31 + N, 2**40, -1, -(2**33)], int(pads.sum()))
        index[:: max(1, K // 7)][1:] = N   # out of range: dropped
        dtype = np.int64 if label == "int64" else np.int32
        worlds[label] = (torch.from_numpy(target), torch.from_numpy(index.astype(dtype)),
                         torch.from_numpy(values))
    return worlds


def cpu_vpa():
    """3z's warm start and passes on the CPU (``tools/vpa_probe``), in a
    worker → (seconds, ``vpa_probe.comparable``)."""
    from autoscaler_tpu_torch.tools import vpa_probe

    t0 = time.perf_counter()
    result = vpa_probe.run_vpa(vpa_probe.vpa_world(**vpa_probe.TENTH), "cpu")
    return time.perf_counter() - t0, vpa_probe.comparable(result)


def cpu_lint():
    """4u's graftlint over the port's tree (``tools/analysis_probe.lint_tree``),
    in a worker → its files, findings, suppressions and seconds."""
    from autoscaler_tpu_torch.tools import analysis_probe

    return analysis_probe.lint_tree()


def cpu_canned(name):
    """4v: the canned scenario ``name`` (``tools/canned``) on the CPU, in a
    worker → (seconds, ``drill_probe.comparable``)."""
    from autoscaler_tpu_torch.tools import canned

    return canned.cpu_view(name)


def main() -> int:
    global _POOL
    # a crash in native code (a kernel's host side, a library) prints every
    # thread's Python stack on standard error before the process dies
    faulthandler.enable(all_threads=True)
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "autoscaler_tpu_torch")):
        log("chip_smoke: autoscaler_tpu_torch/ is missing: run it from a checkout")
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from autoscaler_tpu_torch.estimator.binpacking import (
        BinpackingNodeEstimator,
        _build_group_arrays,
    )
    from autoscaler_tpu_torch.estimator.limiter import ThresholdBasedEstimationLimiter
    from autoscaler_tpu_torch.expander.core import Option, build_strategy
    from autoscaler_tpu_torch.kube.objects import MEMORY, OwnerRef, Taint, Toleration
    from autoscaler_tpu_torch.debugging import DebuggingSnapshotter
    from autoscaler_tpu_torch.ops import _build, ffd_scan, ffd_scan_affinity, fit, fit_reduce
    from autoscaler_tpu_torch.ops import histogram as ops_histogram
    from autoscaler_tpu_torch.snapshot.arena import DeviceArena
    from autoscaler_tpu_torch.snapshot.cluster_snapshot import ClusterSnapshot
    from autoscaler_tpu_torch.snapshot.incremental import IncrementalPacker
    from autoscaler_tpu_torch.snapshot.tensors import bucket_size
    from autoscaler_tpu_torch.main import ObservabilityServer
    from autoscaler_tpu_torch.metrics.metrics import AutoscalerMetrics
    from autoscaler_tpu_torch.tools import (
        analysis_probe,
        bound_loop,
        canned,
        drill_probe,
        fleet_probe,
        k5_bench,
        ladder_probe,
        loop_probe,
        preempt_probe,
        scaledown_probe,
        tick_probe,
        vpa_probe,
    )
    from autoscaler_tpu_torch.utils.test_utils import (
        GB,
        MB,
        anti_affinity,
        build_test_node,
        build_test_pod,
    )
    from autoscaler_tpu_torch.utils.workload import (
        AFFINITY_GROUPS,
        AFFINITY_MAX_NODES,
        AFFINITY_PODS,
        AFFINITY_TERMS,
        HEADLINE_MAX_NODES,
        SPREAD_APPS,
        SPREAD_GROUPS,
        SPREAD_MAX_NODES,
        SPREAD_PODS,
        build_affinity_workload,
        build_fit_workload,
        build_snapshot_world,
        build_spread_world,
        build_workload,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    def phase(label, t0):
        now = time.perf_counter()
        print(f"# phase {label}: {now - t0:.3f} s host clock, {now - t_start:.1f} s since "
              f"the start", flush=True)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind!r}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    # registers and static shared memory ("Used ..."), stack and spills
    # (the line after each function's properties); the carries' dynamic
    # shared memory is printed with each kernel below
    for name, report in sorted(_build.BUILD_LOGS.items()):
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                print(f"# {name}.cu: {line.strip()}", flush=True)

    # -- operands of the main paths (set-up: not part of the paths) --------
    t0 = time.perf_counter()
    req, masks, allocs, caps = build_workload()
    req_frac = req.copy()
    req_frac[:, MEMORY] += 0.5            # fractional memory refuses the SWAR plan
    P = req.shape[0]
    G = masks.shape[0]
    headline = ffd_scan.operands_from_numpy(req, masks, allocs, caps, dev)
    headline_frac = ffd_scan.operands_from_numpy(req_frac, masks, allocs, caps, dev)
    aff_np = build_affinity_workload(AFFINITY_PODS, AFFINITY_GROUPS, AFFINITY_TERMS)
    aff_ops = ffd_scan_affinity.affinity_operands_from_numpy(*aff_np, device=dev)

    rng = np.random.default_rng(0)
    zones = ["zone-a", "zone-b", "zone-c"]
    templates = {}
    for j in range(BURST_TEMPLATES):
        templates[f"ng-{j:03d}"] = build_test_node(
            f"ng-{j:03d}-template",
            cpu_m=float(rng.choice([4000, 8000, 16000, 32000])),
            mem=float(rng.choice([8, 16, 32, 64])) * GB,
            labels={"zone": zones[j % 3]},
            taints=[Taint(key="dedicated", value="batch")] if j % 10 == 9 else None,
        )
    batch = [Toleration(key="dedicated", value="batch", effect="NoSchedule")]
    burst = [
        build_test_pod(
            f"burst-{i}",
            cpu_m=float(rng.integers(50, 2000)),
            mem=float(rng.integers(64, 8192)) * MB,
            node_selector={"zone": zones[i % 3]} if i % 10 == 0 else None,
            tolerations=batch if i % 20 == 0 else None,
        )
        for i in range(BURST_PODS)
    ]
    shapes = [
        (float(rng.integers(50, 2000)), float(rng.integers(64, 8192)) * MB)
        for _ in range(REPLICATED_CONTROLLERS)
    ]
    replicated = []
    for i in range(REPLICATED_PODS):
        c = i % REPLICATED_CONTROLLERS
        pod = build_test_pod(f"rep-{i}", cpu_m=shapes[c][0], mem=shapes[c][1])
        pod.owner_ref = OwnerRef(kind="ReplicaSet", name=f"deploy-{c}")
        replicated.append(pod)
    # the replicated affinity world: the same shapes, an app label per
    # deployment, and hostname anti-affinity on its own app for one
    # deployment in ten
    replicated_aff = []
    for i in range(REPLICATED_PODS):
        c = i % REPLICATED_CONTROLLERS
        pod = build_test_pod(
            f"repaff-{i}", cpu_m=shapes[c][0], mem=shapes[c][1], labels={"app": f"app-{c}"},
            affinity=anti_affinity({"app": f"app-{c}"}) if c % 10 == 0 else None,
        )
        pod.owner_ref = OwnerRef(kind="ReplicaSet", name=f"deploy-{c}")
        replicated_aff.append(pod)
    spread_worlds = {
        "zone": build_spread_world(SPREAD_PODS, SPREAD_GROUPS, SPREAD_APPS),
        "hostname": build_spread_world(
            SPREAD_PODS, SPREAD_GROUPS, SPREAD_APPS, topology_key=HOSTNAME_KEY
        ),
    }
    # the gate worlds: unique pods with fractional memory (the f32 route)
    # and 4 or 3 distinct host ports (one virtual plane each)
    gate_worlds = {}
    for ports in (4, 3):
        g_rng = np.random.default_rng(21)
        pods_g = []
        for i in range(GATE_PODS):
            pod = build_test_pod(f"gate-{i}", cpu_m=float(g_rng.integers(50, 2000)),
                                 mem=(float(g_rng.integers(64, 2048)) + 0.5) * MB)
            if i % 3 == 0:
                pod.host_ports = (9000 + i % ports,)
            pods_g.append(pod)
        gate_worlds[ports] = (pods_g, {
            f"ng-{j}": build_test_node(f"gate-t{j}", cpu_m=4000.0 * (1 + j), mem=8 * GB)
            for j in range(3)
        })
    fit_np = build_fit_workload()
    fit_ops = tuple(torch.tensor(a, device=dev) for a in fit_np)   # copies
    world_nodes, world_pods = build_snapshot_world()
    snapshot = ClusterSnapshot()                   # device=None: the card
    for node in world_nodes:
        snapshot.add_node(node)
    for pod in world_pods:
        snapshot.add_pod(pod)
    world_pending = snapshot.pending_pods()
    # the scale-up ticks: 3b's templates, each copied with the world's zone
    # key beside "zone" (3b's operands stay as they were), and the burst
    # with one pod in twenty of those that carry no selector and no
    # toleration given a zone DoNotSchedule spread on one of the world's
    # first 24 apps (the placed pods of that app count)
    tick_templates = tick_probe.zoned_templates(templates)
    spread_burst = tick_probe.spread_burst(burst)
    # the scale-down runs: the world after a scale-in, and the same with the
    # next 24 apps' placed pods spread by zone
    down_listings = {
        "3m": (scaledown_probe.scale_in_listing(world_nodes, world_pods), {}),
        "3n": (scaledown_probe.scale_in_listing(
            world_nodes, world_pods, spread_apps=scaledown_probe.SPREAD_IN_APPS),
            scaledown_probe.WIDE_REFIT),
    }
    phase("operand set-up", t0)

    # the CPU's side of 4c, 4d and 4g, begun now in worker processes (the
    # CPU's estimator takes its own route there, the torch loops, which
    # take minutes at these sizes); each result is read where its check
    # stands, and 4h's is begun once the card's sequence has run
    import multiprocessing

    _POOL = multiprocessing.get_context("spawn").Pool(
        CPU_WORKERS, initializer=_cpu_worker_init, initargs=(CPU_WORKER_THREADS,))

    def sampled(tmpl_w, stride):
        return {g: tmpl_w[g] for g in sorted(tmpl_w)[::stride]}

    cpu_jobs = {
        "tick 3k": _POOL.apply_async(cpu_tick, (world_nodes, world_pods, spread_burst,
                                                tick_templates)),
        **{f"{variant} spread world": _POOL.apply_async(cpu_estimate, (
            pods_sw, sampled(tmpl_sw, CPU_TEMPLATE_STRIDE), SPREAD_MAX_NODES))
           for variant, (pods_sw, tmpl_sw) in spread_worlds.items()},
        "burst": _POOL.apply_async(cpu_estimate, (burst, templates)),
        "tick 3j": _POOL.apply_async(cpu_tick, (world_nodes, world_pods, burst,
                                                tick_templates)),
        "replicated": _POOL.apply_async(cpu_estimate, (replicated, templates)),
        "replicated affinity world": _POOL.apply_async(cpu_estimate, (
            replicated_aff, sampled(templates, CPU_RUNS_TEMPLATE_STRIDE))),
    }

    class Group:
        def __init__(self, name, template):
            self.name, self.template = name, template

        def id(self):
            return self.name

        def template_node_info(self):
            return self.template

    def event_ms(fn, reps=REPS):
        """Mean device time of ``reps`` calls, by CUDA events. The card
        first spins for HOST_LEAD_CYCLES, so that the host queues the calls
        ahead of it and the events time the card, not the host's launches."""
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def choose(results, tmpls):
        strategy = build_strategy(["least-waste"], seed=0)
        options = [
            Option(node_group=Group(g, tmpls[g]), node_count=n, pods=pods)
            for g, (n, pods) in sorted(results.items()) if n > 0 and pods
        ]
        best = strategy.best_option(options)
        return (best.node_group.id() if best else None), strategy.last_table

    counters = (ffd_scan.LAUNCHES, ffd_scan_affinity.LAUNCHES, fit_reduce.LAUNCHES,
                ops_histogram.LAUNCHES)
    launches = {name: 0 for d in counters for name in d}
    # every estimator on the card counts on card_metrics; the watch reads
    # its ladder counters and the estimator logger's warnings per path
    card_metrics = AutoscalerMetrics()
    watch = ladder_probe.LadderWatch(card_metrics)

    def run_path(label, fn):
        """Drive one main path with every count set to 0 just before it;
        → (its result, its counts read just after, host seconds). The
        counts hold the kernels' launches and the estimators' served routes
        ("route:<route>", "route:<route>:<reason>"); the path fails if its
        ladders did what they must not on the card
        (``tools/ladder_probe.LadderWatch``)."""
        for d in counters:
            for k in d:
                d[k] = 0
        watch.reset()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**ffd_scan.LAUNCHES, **ffd_scan_affinity.LAUNCHES, **fit_reduce.LAUNCHES,
                  **ops_histogram.LAUNCHES, **watch.counts()}
        for name in launches:
            launches[name] += counts[name]
        print(f"# path {label}: {secs:.3f} s host clock, counts {counts}", flush=True)
        check(not watch.problems(), f"path {label}: the kernel ladder {watch.problems()}")
        return out, counts, secs

    def launched(counts) -> int:
        return sum(counts[name] for name in launches)

    # -- 3. the main paths ----------------------------------------------------
    t3 = time.perf_counter()
    (res_swar, res_f32), counts, t_headline = run_path("headline K2+K1", lambda: (
        ffd_scan.ffd_binpack_groups_cuda(
            *headline[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline[3]
        ),
        ffd_scan.ffd_binpack_groups_cuda(
            *headline_frac[:3], max_nodes=HEADLINE_MAX_NODES, node_caps=headline_frac[3]
        ),
    ))
    check(counts["ffd_scan_swar"] == 1 and counts["ffd_scan_f32"] == 1,
          "the headline did not run K2 and K1 once each")
    estimator = BinpackingNodeEstimator(metrics=card_metrics)   # device=None: the card

    def burst_path():
        out = estimator.estimate_many(burst, templates)
        return out, choose(out, templates)

    (burst_card, choice_card), counts, t_burst = run_path("30k burst + expander", burst_path)
    check(counts["ffd_scan_swar"] == 1 and counts.get("route:cuda:ok") == 1,
          "the burst estimate did not run the SWAR kernel")
    replicated_card, counts, t_replicated = run_path(
        "replicated burst", lambda: estimator.estimate_many(replicated, templates)
    )
    check(not launched(counts) and counts.get("route:torch_runs:dedup") == 1,
          "the replicated burst did not take the runs route")
    res_aff, counts, t_aff = run_path(
        "affinity workload K3",
        lambda: ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
            **aff_ops, max_nodes=AFFINITY_MAX_NODES
        ),
    )
    check(counts["ffd_scan_aff"] == 1, "the affinity workload did not run K3")

    # the spread worlds: capture the operands K3 is handed and what it
    # returns, to hold it against its plain version and time it below (the
    # capture calls the wrapper itself, which counts)
    spread_estimator = BinpackingNodeEstimator(
        ThresholdBasedEstimationLimiter(max_nodes=SPREAD_MAX_NODES), metrics=card_metrics
    )
    captured = {}
    real_scan = ffd_scan_affinity.ffd_scan_aff
    spread_card = {}
    for variant, (pods_sw, tmpl_sw) in spread_worlds.items():
        def spread_path():
            out = spread_estimator.estimate_many(pods_sw, tmpl_sw)
            return out, choose(out, tmpl_sw)

        def capture(ops, variant=variant):
            out = real_scan(ops)
            captured[variant] = (ops, out)
            return out

        ffd_scan_affinity.ffd_scan_aff = capture
        try:
            spread_card[variant] = run_path(f"spread world ({variant})", spread_path)
        finally:
            ffd_scan_affinity.ffd_scan_aff = real_scan
        counts = spread_card[variant][1]
        check(counts["ffd_scan_aff"] == 1 and counts.get("route:cuda_affinity:ok") == 1
              and counts.get("route:torch_scan", 0) == 0,
              f"the {variant} spread world did not take the cuda_affinity route")
        check(captured[variant][0].num_spread == 32, f"{variant}: expected 32 spread terms")
    replicated_aff_card, counts, t_replicated_aff = run_path(
        "replicated affinity world",
        lambda: estimator.estimate_many(replicated_aff, templates),
    )
    check(not launched(counts) and counts.get("route:torch_runs:dedup") == 1,
          "the replicated affinity world did not take the runs-affinity route")

    res_fit, counts, t_fit = run_path(
        "fit-K4", lambda: fit_reduce.fit_reduce_cuda(*fit_ops)
    )
    check(counts["fit_reduce"] == 1, "the tiled fit did not run K4 once")

    # the snapshot probe: capture the operands K4 is handed and what it
    # returns, to hold it against its plain version and time it below
    debugger = DebuggingSnapshotter()
    stand_in = SimpleNamespace(provider=SimpleNamespace(node_groups=lambda: [
        Group(f"pool-{k}", world_nodes[k]) for k in range(3)
    ]))
    last_result = SimpleNamespace(
        scale_up=None, pending_pods=len(world_pending), unneeded_nodes=[]
    )
    probe_launches = []
    real_fit = fit_reduce.fit_reduce_cuda

    rows_launches = []
    real_rows = fit_reduce.fit_reduce_rows

    def capture_fit(*operands):
        out = real_fit(*operands)
        probe_launches.append((operands, out))
        return out

    def capture_rows(*operands):
        out = real_rows(*operands)
        rows_launches.append((operands, out))
        return out

    def probe_path():
        t0 = time.perf_counter()
        tensors, meta = snapshot.tensors()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        debugger.request()
        debugger.capture(stand_in, snapshot, world_pending, last_result, now=0.0)
        first = fit.first_fit_node(tensors)
        torch.cuda.synchronize()
        return tensors, meta, first, t1 - t0, time.perf_counter() - t1

    fit_reduce.fit_reduce_cuda = capture_fit
    fit_reduce.fit_reduce_rows = capture_rows
    try:
        (probe_t, probe_meta, probe_first, t_pack, t_probe), counts, _ = run_path(
            "snapshot probe", probe_path
        )
    finally:
        fit_reduce.fit_reduce_cuda = real_fit
        fit_reduce.fit_reduce_rows = real_rows
    check(counts["fit_reduce"] == 2, "the snapshot probe did not run K4 twice")
    check(probe_t.sched_mask is None, "the snapshot world did not pack factored")
    n_exc = int((probe_t.pod_exc >= 0).sum())
    n_cells = int((probe_t.cell_pod >= 0).sum())
    check(n_exc > 0 and n_cells > 0, "the factored pack has no exception rows or no cells")
    payload = json.loads(debugger.get())
    n_fitting = len(payload["pending_pods_fitting_free_capacity"])
    check(n_fitting > 0, "the probe found no pending pod fitting free capacity")
    print(
        f"# snapshot probe: {probe_meta.num_nodes} nodes, {probe_meta.num_pods} pods "
        f"({len(world_pending)} pending), padded {probe_t.num_pods} x {probe_t.num_nodes}, "
        f"factored: class mask {list(probe_t.class_mask.shape)}, exception rows "
        f"{n_exc} of {probe_t.exc_rows.shape[0]}, cells {n_cells} of "
        f"{probe_t.cell_pod.shape[0]}; pack {t_pack:.3f} s host clock, probe "
        f"(capture + first_fit_node) {t_probe:.3f} s host clock; {n_fitting} pending "
        f"pods fit free capacity, {int((probe_first >= 0).sum())} pods have a first fit",
        flush=True,
    )
    check(counts["fit_reduce_rows"] == 2, "the snapshot probe did not run K4's rows entry twice")

    # the plain route's gate: 7 f32 planes at a scan cap of 8192 ask for
    # more shared memory than a block may use (the cuda rung's gate answers
    # smem and the torch loop serves); 6 planes launch K1
    gate_limiter = ThresholdBasedEstimationLimiter(max_nodes=GATE_MAX_NODES)
    gate_card = {}
    for ports, route in ((4, "torch_scan:smem"), (3, "cuda:ok")):
        pods_g, tmpl_g = gate_worlds[ports]
        out, counts, _ = run_path(
            f"plain-route gate ({3 + ports} planes)",
            lambda: BinpackingNodeEstimator(gate_limiter, metrics=card_metrics).estimate_many(
                pods_g, tmpl_g),
        )
        served = {k: v for k, v in counts.items() if k.count(":") == 2}
        check(served == {f"route:{route}": 1}
              and counts["ffd_scan_f32"] == int(route == "cuda:ok"),
              f"the {3 + ports}-plane world did not take the {route} route: {served}")
        gate_card[ports] = out
    # the scale-up half of a reconcile tick (static_autoscaler.py:629-631,
    # :712): fork, filter-out-schedulable, revert, scale_up on the
    # TestCloudProvider; the burst without (3j) and with (3k) spread
    tick_card = {}
    for label, extra in (("3j", burst), ("3k", spread_burst)):
        rec, counts, _ = run_path(f"scale-up tick {label}", lambda extra=extra: tick_probe.run_tick(
            world_nodes, world_pods, extra, tick_templates, dev, timed=True,
            metrics=card_metrics))
        tick_card[label] = rec
        out = rec["out"]
        route = [k for k in ("cuda", "cuda_affinity") if counts.get(f"route:{k}:ok")]
        check(len(route) == 1 and sum(v for k, v in counts.items() if k.count(":") == 2) == 1,
              f"tick {label}: the estimate did not take one kernel route: {counts}")
        kernel_launches = (counts["ffd_scan_swar"] + counts["ffd_scan_f32"]
                           if route[0] == "cuda" else counts["ffd_scan_aff"])
        check(kernel_launches == 1 and counts["fit_reduce"] == 0,
              f"tick {label}: the estimate did not launch the kernel of its route {route[0]}")
        check(label == "3j" or route[0] == "cuda_affinity",
              "tick 3k: the spread leftovers did not take K3")
        check(rec["greedy_devices"] == ("cuda", "cuda"),
              f"tick {label}: greedy_schedule's outputs are not on the card")
        check(rec["reverted"], f"tick {label}: revert() did not restore the snapshot")
        res = out["result"]
        check(res.scaled_up and res.new_nodes > 0 and out["filtered"] and out["still"],
              f"tick {label}: filtered nothing, left nothing or scaled nothing")
        rec["route"] = route[0]
        grown = {g: n for g, n in out["sizes"] if n}
        print(
            f"# tick {label}: {rec['pending']} pending in ({len(extra)} burst), "
            f"{len(out['filtered'])} filtered onto existing nodes, {len(out['still'])} "
            f"still pending; route {route[0]}, launches "
            f"{ {k: v for k, v in counts.items() if v} }; spread terms S = "
            f"{rec['spread_terms']} interned (K3's S = {rec['k3_spread']}); chosen "
            f"{res.chosen_group}, new_nodes {res.new_nodes}, executed {res.executed}, "
            f"{res.options_considered} options; target sizes after: {grown}", flush=True,
        )
    check(tick_card["3k"]["spread_terms"] <= 32 and tick_card["3k"]["k3_spread"] <= 32,
          "tick 3k: more spread terms than K3's bitset holds")
    # the tick sequence over one incremental packer: tick 1 on 3j's listing
    # (the packer's first update, a full build), then two churns as a watch
    # cache delivers them (tick_probe.CHURNS), each followed by a tick whose
    # pack is the delta alone
    seq_packer = IncrementalPacker(device=dev)
    seq, counts, _ = run_path("tick sequence (3 ticks)", lambda: tick_probe.run_sequence(
        world_nodes, list(world_pods) + burst, tick_templates, dev, seq_packer, timed=True,
        metrics=card_metrics))
    cpu_jobs["sequence"] = _POOL.apply_async(cpu_sequence, (
        [(nodes_k, pods_k) for nodes_k, pods_k, *_ in seq], tick_templates))
    check([rec["packer"]["full_packs"] for *_, rec in seq] == [1, 1, 1]
          and [rec["packer"]["incremental_updates"] for *_, rec in seq] == [0, 1, 2],
          "tick sequence: ticks 2 and 3 were not incremental")
    check(counts.get("route:cuda:ok") == len(seq)
          and counts["ffd_scan_swar"] + counts["ffd_scan_f32"] == len(seq),
          f"tick sequence: each tick's estimate did not launch K1/K2 once: {counts}")
    diff = tick_probe.tick_differences(seq[0][3]["out"], tick_card["3j"]["out"])
    check(not diff, f"tick sequence: tick 1 differs from tick 3j in {diff}")
    for k, entry in enumerate(seq):
        nodes_k, pods_k, churned, rec = entry
        rec["route"] = rec["kernel"][0]
        print(tick_probe.sequence_line(str(k + 1), entry), flush=True)
        check(rec["greedy_devices"] == ("cuda", "cuda") and rec["reverted"]
              and rec["out"]["filtered"], f"tick sequence: tick {k + 1} did not filter on the card")
        check(len(pods_k) < rec["tensors"].num_pods and len(nodes_k) < rec["tensors"].num_nodes,
              f"tick sequence: tick {k + 1} outgrew its buckets")
        if churned is not None:
            changed = churned["bound"] + churned["removed"] + churned["arrived"]
            check(rec["packer"]["pod_rows"] <= 2 * changed,
                  f"tick sequence: tick {k + 1} dirtied {rec['packer']['pod_rows']} pod rows "
                  f"for {changed} changed pods")
    # the scale-down half of two reconcile loops, with the defaults (3m) and
    # with every eligible non-empty node simulated under spread (3n)
    down_card = {}
    for label, (listing, options_kw) in down_listings.items():
        rec, counts, _ = run_path(f"scale-down {label}", lambda listing=listing, kw=options_kw: (
            scaledown_probe.run_scale_down(*listing, dev, kw, timed=True)))
        down_card[label] = rec
        check(not any(counts.values()), f"scale-down {label} launched a kernel: {counts}")
        (loop1, loop2), act = rec["out"]["loops"], rec["out"]["actuation"]
        check(not loop1["plan"]["empty"] and not loop1["plan"]["drain"],
              f"scale-down {label}: the first loop planned deletions")
        check(loop2["plan"]["empty"] and act["deleted_empty"] and not act["failed"],
              f"scale-down {label}: the second loop deleted no empty node")
        fn, ops = rec["loops"][-1]["dispatch_ops"]
        check(ops[0].pod_req.device == dev and ops[1].device == dev,
              f"scale-down {label}: the removal dispatch did not run on the card")
        if label == "3m":
            check(len(loop2["simulated"]) == 30 and fn is not None,
                  "scale-down 3m: not 30 candidates simulated")
        else:
            check(fn.__name__ == "removal_feasibility_spread"
                  and len(loop2["simulated"]) == loop2["pool"] > 1000,
                  "scale-down 3n: the wide spread refit did not run")
            check(rec["loops"][-1]["joint_ops"][0].__name__ == "joint_removal_feasibility_spread"
                  and act["deleted_drain"] and act["evicted_pods"],
                  "scale-down 3n: no drain was validated jointly and deleted")
        print(scaledown_probe.summary_line(label, rec), flush=True)
    # the reconcile loop: three run_once ticks of one StaticAutoscaler on
    # the card over 3m's listing with 3j's burst and groups (3o); every
    # kernel launch is captured with copies of its operands and outputs, to
    # hold against its plain version in 4m
    loop_nodes, loop_pods = down_listings["3m"][0]
    with loop_probe.KernelCapture() as loop_capture:
        loop_card, counts, t_loop = run_path("reconcile loop 3o (3 ticks)", lambda: (
            loop_probe.run_loop_ticks(loop_nodes, loop_pods, burst, tick_templates, None,
                                      timed=True, debugger=DebuggingSnapshotter(),
                                      metrics=card_metrics)))
    check(all(loop_capture.counts()[name] == counts[name] for name in launches),
          f"reconcile loop: launches {counts} but captured {loop_capture.counts()}")
    loop_sa = loop_card["autoscaler"]
    check(loop_sa.device == dev and loop_sa._packer.device == dev,
          "reconcile loop: the autoscaler does not run on the card")
    check(counts.get("route:cuda:ok", 0) >= 1
          and counts["ffd_scan_swar"] + counts["ffd_scan_f32"] >= 1,
          f"reconcile loop: no estimate launched K1/K2: {counts}")
    check(counts.get("route:cuda_affinity:ok") == 1 and counts["ffd_scan_aff"] == 1,
          f"reconcile loop: tick 3's estimate did not launch K3: {counts}")
    check(loop_sa.degraded_rungs() == [] and len(loop_sa.observatory.records()) == 3,
          "reconcile loop: a degraded rung, or not one perf record a tick")
    check(counts["fit_reduce"] >= 2 * len(loop_probe.LOOP_TICKS),
          f"reconcile loop: the journal probes did not run K4: {counts}")
    for k, entry in enumerate(loop_card["ticks"]):
        print(loop_probe.tick_line(str(k + 1), entry), flush=True)
        r = entry["result"]
        check(r.cluster_healthy and not r.errors, f"reconcile loop tick {k + 1}: {r.errors}")
        check(entry["probe"]["checked"] and not entry["probe"]["drift"],
              f"reconcile loop tick {k + 1}: the journal probe found drift {entry['probe']}")
    first, second, third = (e["result"] for e in loop_card["ticks"])
    check(first.scale_up is not None and first.scale_up.scaled_up and first.filtered_schedulable
          and first.scale_down_in_cooldown, "reconcile loop: tick 1 did not filter and scale up")
    check(second.scale_down is not None and second.scale_down.deleted_empty,
          "reconcile loop: tick 2 deleted no empty node")
    check(third.scale_up is not None and third.scale_up.estimator_explain["pod_reasons"],
          "reconcile loop: tick 3 did not estimate its arrivals")
    check(len(loop_sa.journal.records()) == 3 and len(loop_sa.explainer.records()) == 3
          and len(loop_sa.slo.records()) == 3, "reconcile loop: a ledger missed a tick")
    # the observability server on 3o's autoscaler (3p)
    t0 = time.perf_counter()
    import urllib.error
    import urllib.request

    server = ObservabilityServer(loop_sa, "127.0.0.1:0", profiling=True)
    port = server.start()

    def http_get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    try:
        answers = {path: http_get(path) for path in (
            "/metrics", "/health-check", "/snapshotz", "/tracez", "/tracez?id=2",
            "/explainz", "/explainz?tick=2", "/sloz", "/journalz", "/journalz?diff=0,2",
            "/status", "/debug/pprof/", "/debug/pprof/threadz", "/perfz", "/perfz?tick=2")}
    finally:
        server.stop()
    for path, (code, body) in answers.items():
        check(code == 200 and body, f"server: {path} answered {code}")
    check(len(json.loads(answers["/perfz"][1])["ticks"]) == 3
          and json.loads(answers["/perfz?tick=2"][1])["dispatches"]
          and "degraded" not in answers["/health-check"][1]
          and len(json.loads(answers["/explainz"][1])["ticks"]) == 3
          and len(json.loads(answers["/journalz"][1])["ticks"]) == 3
          and json.loads(answers["/snapshotz"][1])["pending_pods"] is not None
          and "cluster_autoscaler_scaled_up_nodes_total" in answers["/metrics"][1],
          "server: the bodies do not hold 3o's ticks")
    print(f"# server 3p: {len(answers)} endpoints, "
          f"{ {p: c for p, (c, _) in answers.items()} }, bytes "
          f"{ {p: len(b) for p, (_, b) in answers.items()} }; "
          f"{time.perf_counter() - t0:.3f} s host clock", flush=True)
    # the port's process entry on the card (3q)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "autoscaler_tpu_torch.main", "--provider=test",
         "--max-iterations=2", "--scan-interval=0", "--address=:0"],
        cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
        timeout=300,
    )
    print(f"# main 3q: exit {proc.returncode}, {time.perf_counter() - t0:.3f} s host clock; "
          f"{proc.stdout.strip()[-200:]!r}", flush=True)
    check(proc.returncode == 0 and "device cuda:0" in proc.stdout,
          f"main: exit {proc.returncode}: {proc.stderr[-2000:]}")
    # the bound reconcile loop (3r), at 4l's tenth of 3o's world (the full
    # size is tools/bound_loop's own run: chip_smoke runs it at a tenth to
    # stay inside its time): served over HTTP by the fake Kubernetes API of
    # tools/binding_probe (a child process), the kube client's watch caches,
    # the clusterapi provider and a live priority ConfigMap, three ticks
    # under Lease election with 3o's churn pushed as watch events, on the
    # tracer's replayable clock; 4n holds each tick against 3o's at a tenth
    # (4l) and against the same ticks on the CPU
    tenth = loop_probe.loop_world(tenth=True)
    arrive = loop_probe.ARRIVALS // 10
    errors_before = sum(card_metrics.errors_total.values.values())
    bound, counts, t_bound = run_path("bound loop 3r (3 ticks over HTTP, at a tenth)", lambda: (
        bound_loop.run_bound_ticks(*tenth, dev, arrive=arrive, replayable=True, timed=True,
                                   metrics=card_metrics)))
    first = bound["first"]
    print(f"# bound 3r: world served in {bound['load_s']:.3f} s; first list of "
          f"{first['items']} pods, {first['bytes']} bytes: HTTP read {first['http_read_s']:.3f} s, "
          f"json.loads {first['json_loads_s']:.3f} s, convert (tick 1's list_pods) "
          f"{first['convert_s']:.3f} s; "
          f"watch caches synced in {bound['synced_s']:.3f} s", flush=True)
    for k, entry in enumerate(bound["ticks"]):
        print(bound_loop.bound_line(str(k + 1), entry), flush=True)
        check(entry["probe"]["checked"] and not entry["probe"]["drift"],
              f"bound loop tick {k + 1}: the journal probe found drift {entry['probe']}")
        problems = bound_loop.write_problems(entry)
        check(not problems, f"bound loop tick {k + 1}: writes do not match the decisions: "
              f"{problems}")
    holders = bound_loop.lease_holders(bound["writes"])
    check(holders == {bound_loop.IDENTITY}, f"bound loop: Lease holders {holders}")
    check(counts["ffd_scan_swar"] >= 1 and counts.get("route:cuda_affinity:ok") == 1
          and counts["ffd_scan_aff"] == 1 and counts["fit_reduce"] >= len(bound["ticks"])
          and counts["fit_reduce_rows"] >= 1,
          f"bound loop: not K2, K3, K4 and its rows entry: {counts}")
    check(sum(card_metrics.errors_total.values.values()) == errors_before,
          "bound loop: errors_total counted")
    print(f"# bound 3r: {t_bound:.3f} s host clock, {len(bound['writes'])} writes, the "
          f"Lease held by {holders}", flush=True)
    # the port's process entry with the gce provider, on the card, against
    # the fake kube and Compute APIs at 4l's size (3s)
    t0 = time.perf_counter()
    gce = bound_loop.run_gce_main(*tenth[:3], root)
    resizes = [path for m, path, _ in gce["compute_writes"] if "/resize?" in path]
    gce_status = [path for m, path, _ in gce["kube_writes"]
                  if path.endswith("/configmaps/cluster-autoscaler-status")]
    gce_leases = bound_loop.lease_holders(gce["kube_writes"])
    gce_launched = gce["launches"]
    for name in launches:
        launches[name] += gce_launched.get(name, 0)
    print(f"# main 3s (gce): exit {gce['rc']}, {gce['seconds']:.3f} s; resizes {resizes}; "
          f"status writes {len(gce_status)}; Lease taken by {gce_leases}; launches "
          f"{gce_launched}; {time.perf_counter() - t0:.3f} s host clock", flush=True)
    check(gce["rc"] == 0 and "device cuda:0" in gce["stdout"],
          f"main 3s: exit {gce['rc']}: {gce['stderr'][-2000:]}")
    check(resizes and len(gce_status) >= 2 and len(gce_leases) == 1 and None not in gce_leases,
          "main 3s: no resize, status ConfigMap or Lease")
    check(gce_launched.get("ffd_scan_swar", 0) + gce_launched.get("ffd_scan_f32", 0) >= 1
          and gce_launched.get("fit_reduce", 0) >= 2,
          f"main 3s: its estimate or journal probes launched no kernel: {gce_launched}")
    # the port as it is installed and started (3s2): (a) every library
    # prebuilt by build_kernels in a subprocess into a fresh directory; (b)
    # 3s's run from an installed copy outside the checkout (what the wheel
    # ships) on that directory: no compiler starts, nothing is written into
    # the copy, the decisions are 3s's; (c) the same on an empty directory:
    # the loop's libraries are built at the start, before tick 0
    from autoscaler_tpu_torch.tools import install_probe

    installed = install_probe.run_3s2(root, tenth[:3], resizes)
    for line in install_probe.report(installed, smi_line):
        print(f"# install 3s2 {line}", flush=True)
    check(not installed["problems"], f"install 3s2: {installed['problems']}")
    for run in installed["runs"].values():
        for name in launches:
            launches[name] += run["launches"].get(name, 0)
    # the preemption pass on the reconcile loop (3t): 3o's world and churn
    # with the storm's priorities and wave, three run_once ticks with
    # --preemption-enabled and a churn weight, the journal on; the pass is
    # the estimator's torch loop on the card (no hand kernel); then the
    # port's journal CLI replays the ticks on the card. The CPU's side of
    # 4o begins now in a worker
    # The storm runs at 4l's tenth of its world (the full size is
    # tools/preempt_probe's own run: chip_smoke runs it at a tenth to stay
    # inside its time), on the tracer's replayable clock; 4o holds these
    # ticks against the same on the CPU
    t0 = time.perf_counter()
    storm_tenth = preempt_probe.preempt_world(tenth=True)
    cpu_jobs["preempt 4o"] = _POOL.apply_async(cpu_preempt, (storm_tenth,))
    storm = storm_tenth
    print(f"# preempt 3t: {len(storm[0])} nodes, {len(storm[1])} pods, {len(storm[2])} "
          f"pending (burst and wave), world built in {time.perf_counter() - t0:.3f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    storm_card, counts, t_storm = run_path("preemption storm 3t (3 ticks, at a tenth)", lambda: (
        preempt_probe.run_preempt_ticks(*storm, dev, timed=True, arrive=loop_probe.ARRIVALS // 10,
                                        replayable=True, metrics=card_metrics)))
    storm_sa = storm_card["autoscaler"]
    peak = torch.cuda.max_memory_allocated(dev)
    # the pass's operand signature names the snapshot's P and N
    storm_sigs = sorted({d["sig"].rsplit(";", 1)[-1] for rec in storm_sa.observatory.records()
                         for d in rec["dispatches"] if d["route"] == "torch_preempt"})
    storm_passes = sum(e["preemption"]["route"] is not None for e in storm_card["ticks"])
    for k, entry in enumerate(storm_card["ticks"]):
        print(loop_probe.tick_line(str(k + 1), entry).replace("# loop tick", "# preempt 3t tick"),
              flush=True)
        print(preempt_probe.plan_line(str(k + 1), entry).replace("# preempt", "# preempt 3t"),
              flush=True)
        r = entry["result"]
        check(r.cluster_healthy and not r.errors, f"preempt 3t tick {k + 1}: {r.errors}")
        check(entry["probe"]["checked"] and not entry["probe"]["drift"],
              f"preempt 3t tick {k + 1}: the journal probe found drift {entry['probe']}")
    first_storm = storm_card["ticks"][0]["preemption"]
    check(first_storm["route"] == "torch_preempt" and first_storm["eligible"] > 0
          and first_storm["admitted"] > 0 and first_storm["planned"] > 0,
          f"preempt 3t: tick 1's pass planned nothing: {first_storm}")
    check(counts.get("route:torch_preempt:unsupported", 0) == storm_passes > 0,
          f"preempt 3t: the torch loop did not serve every pass on the card: {counts}")
    check(counts["ffd_scan_swar"] + counts["ffd_scan_f32"] >= 1
          and counts["fit_reduce"] >= 2 * len(loop_probe.LOOP_TICKS),
          f"preempt 3t: K1/K2 in tick 1 or K4 in the journal probes did not launch: {counts}")
    check(storm_sa.preempt_engine.estimator.device == dev,
          "preempt 3t: the preemption pass does not run on the card")
    storm_replay = preempt_probe.replay(storm_sa)
    print(f"# preempt 3t: {t_storm:.3f} s host clock for the ticks, churns included; "
          f"preemptPlan spans {[round(e['split']['preempt'], 6) for e in storm_card['ticks']]} "
          f"s; the pass's [P, N] mask operand {storm_sigs} read as rows; peak card memory "
          f"{peak} bytes over the ticks; journal replay on the card (python -m "
          f"autoscaler_tpu_torch.journal replay): exit {storm_replay['rc']}, "
          f"{storm_replay['verdict']}, {storm_replay['seconds']:.3f} s", flush=True)
    check(storm_replay["rc"] == 0 and storm_replay["verdict"]["diverged"] == 0
          and storm_replay["verdict"]["replayed"] >= 1,
          f"preempt 3t: the journal replay diverged: {storm_replay}")
    del storm, storm_sa
    # the what-if at BASELINE config 5 (3u): 3a's headline operands under 8
    # spot-pricing scenarios on a 1x1 mesh of the card, each scenario's FFD
    # one K2 launch; every scenario's counts must be 3a's K2 counts and the
    # costs, best groups and best costs the host's f32 recomputation
    wi_start = torch.cuda.Event(enable_timing=True)
    wi_stop = torch.cuda.Event(enable_timing=True)

    def whatif_path():
        wi_start.record()
        out = fleet_probe.whatif_path(dev, req, masks, allocs, caps, HEADLINE_MAX_NODES)
        wi_stop.record()
        return out

    (whatif, whatif_ops), counts, t_whatif = run_path("what-if 3u (8 scenarios)", whatif_path)
    whatif_ms = wi_start.elapsed_time(wi_stop)
    check(counts["ffd_scan_swar"] == fleet_probe.SCENARIOS and counts["ffd_scan_f32"] == 0,
          f"what-if 3u: not one K2 launch a scenario: {counts}")
    bad = fleet_probe.whatif_problems(whatif, res_swar.node_count.cpu().numpy(),
                                      res_swar.scheduled.cpu().numpy(), req, whatif_ops[3])
    check(not bad, f"what-if 3u: {bad}")
    print(f"# what-if 3u: {fleet_probe.SCENARIOS} scenarios x {G} groups x {P} pods, "
          f"{whatif_ms:.3f} ms on the card's clock ({whatif_ms / fleet_probe.SCENARIOS:.3f} ms a "
          f"scenario, its K2 launch, plan fetch and sort), {t_whatif:.3f} s host clock; best "
          f"groups {whatif.best_group.tolist()}, best costs {whatif.best_cost.tolist()}; every "
          f"scenario's counts equal 3a's K2 counts, costs and argmins the host's", flush=True)
    # the scenario expander over the expansion options of 3b's estimate
    (strategy, strat_options, strat_choice), counts, t_strategy = run_path(
        "scenario expander 3u", lambda: fleet_probe.strategy_path(
            dev, burst_card, templates, HEADLINE_MAX_NODES))
    check(strategy.last_route == "cuda" and counts["ffd_scan_swar"] + counts["ffd_scan_f32"]
          == fleet_probe.SCENARIOS, f"scenario expander 3u: not on K1/K2: {counts}")
    bad = fleet_probe.strategy_problems(strategy, strat_options, strat_choice, dev)
    check(not bad, f"scenario expander 3u: {bad}")
    print(f"# scenario expander 3u: {len(strat_options)} options, "
          f"{strategy.last_whatif.node_counts.shape[0]} scenarios, chose "
          f"{strat_choice.node_group.id()} (best groups "
          f"{strategy.last_whatif.best_group.tolist()}), {t_strategy:.3f} s host clock; "
          f"launches {counts}", flush=True)
    # K3 over a 1-device group mesh on the affinity workload (3d's operands)
    res_sharded, counts, t_sharded = run_path("sharded affinity 3u", lambda: (
        fleet_probe.affinity_path(dev, aff_ops, AFFINITY_MAX_NODES)))
    check(counts["ffd_scan_aff"] == 1, f"sharded affinity 3u: not one K3 launch: {counts}")
    check(all(torch.equal(a, b) for a, b in zip(res_sharded, res_aff)),
          "sharded affinity 3u: differs from 3d's K3 result")
    print(f"# sharded affinity 3u: one K3 launch on a 1-device group mesh, equal to 3d's; "
          f"{t_sharded:.3f} s host clock", flush=True)
    del whatif, whatif_ops, strategy, res_sharded
    # the fleet (3v): a prewarmed coalescer on a 1x1 mesh of the card serves
    # 16 tenants of bench.py --fleet's form at real widths and one past
    # every bucket in one flush; every batch one K1/K2 launch (captured for
    # 4q), every answer byte-equal to the tenant's solo dispatch, every
    # what-if best group the host's f64 argmin; then batched and sequential
    # rounds timed as bench.py --fleet times them. The CPU's side of 4q
    # begins now in a worker
    cpu_jobs["fleet 4q"] = _POOL.apply_async(cpu_fleet, ())
    fleet_reqs = fleet_probe.fleet_tenants()
    fleet_out, counts, t_served = run_path("fleet 3v (17 tenants)", lambda: fleet_probe.serve(
        fleet_reqs, dev, AutoscalerMetrics(), reps=REPS, capture=True))
    bad = fleet_probe.serve_problems(fleet_reqs, fleet_out)
    check(not bad and fleet_out["batches"] == len(fleet_out["captured"]) >= 3,
          f"fleet 3v: {bad}, {fleet_out['batches']} batches, {len(fleet_out['captured'])} launches")
    fleet_batch = max(fleet_out["captured"], key=lambda c: c[1][0].numel())
    fleet_batch_ms = event_ms(lambda: getattr(ffd_scan, fleet_batch[0])(*fleet_batch[1]))
    n_req = len(fleet_reqs)
    out = fleet_out
    print(f"# fleet 3v: {n_req} tenants, buckets {fleet_probe.BUCKETS} (prewarmed "
          f"{out['warmed']} in {out['prewarm_s']:.3f} s), {out['batches']} batches "
          f"{sorted(set(a.bucket for a in out['answers']))}, launches {out['launches']}, "
          f"routes {out['routes']}; served in {out['serve_s']:.3f} s; batched "
          f"{n_req / out['batched_s']:.1f} tenant-requests/s ({out['batched_s']:.5f} s a "
          f"round), sequential {n_req / out['sequential_s']:.1f} ({out['sequential_s']:.5f} "
          f"s), {out['sequential_s'] / out['batched_s']:.2f}x; the largest batch's launch "
          f"{fleet_batch[0]} on stream {list(fleet_batch[1][0].shape)} {fleet_batch_ms:.3f} ms; "
          f"path {t_served:.3f} s host clock", flush=True)
    # the estimator's fleet lane: two estimators on the card, each with a
    # FleetEstimatorClient on one started coalescer (5 ms window), each a
    # 3 000-pod slice of 3b's burst x 3b's templates from a thread of its
    # own; each result must equal the same estimator's solo estimate
    lane, counts, t_lane = run_path("fleet lane 3v", lambda: fleet_probe.estimator_lane(
        burst, templates, dev, metrics=card_metrics))
    check(all(lane["equal"]) and not lane["errors"] and counts.get(
        "route:fleet_coalesced:ok") == 2, f"fleet lane 3v: {lane['equal']} {lane['errors']} "
          f"{counts}")
    print(f"# fleet lane 3v: 2 estimators x {fleet_probe.LANE_PODS} pods x {len(templates)} "
          f"groups, {lane['batches']} batches, scheduled {lane['scheduled']}, each equal to its "
          f"solo estimate; {lane['seconds']:.3f} s for the lane, {t_lane:.3f} s with the solo "
          f"estimates", flush=True)
    # the scenario engine (3w-3y; tools/drill_probe). The CPU's sides of 4r
    # and 4s begin now in workers
    cpu_jobs["drill 4r"] = _POOL.apply_async(cpu_drill, ())
    cpu_jobs["tune 4s"] = _POOL.apply_async(cpu_tune, ())
    cpu_jobs["vpa 4t"] = _POOL.apply_async(cpu_vpa, ())
    cpu_jobs["lint 4u"] = _POOL.apply_async(cpu_lint, ())
    # 3w: Cluster Autoscaler's scalability drill at full size through
    # run_scenario on the card: 30 000 pods on 1 000 nodes, then 300
    # emptied nodes deleted
    (drill, drill_s), counts, t_drill = run_path("scale drill 3w", lambda: drill_probe.run_drill(
        drill_probe.drill_doc(), dev))
    drill_line = drill_probe.drill_summary(drill, drill_s)
    print(f"# scale drill 3w: {json.dumps(drill_line, sort_keys=True)}", flush=True)
    print(f"# scale drill 3w: routes a tick {drill_probe.kernels_by_tick(drill)}; launches "
          f"{ {k: v for k, v in counts.items() if k in launches} }", flush=True)
    bad = drill_probe.drill_problems(drill)
    check(not bad, f"scale drill 3w: {bad}")
    del drill
    # 3x: the fleet drill in the shape of the canned fleet_tenants scenario
    # through fleetdrive on the card: every answer equal to its solo dispatch
    (fleet_drill, fleet_drill_s), counts, _ = run_path(
        "fleet drill 3x", lambda: drill_probe.run_fleet(drill_probe.fleet_doc(), dev))
    fleet_report = drill_probe.fleet_summary(fleet_drill, fleet_drill_s)
    print(f"# fleet drill 3x: {json.dumps(fleet_report, sort_keys=True)}; launches "
          f"{ {k: v for k, v in counts.items() if k in launches} }", flush=True)
    check(fleet_drill.all_match() and counts["ffd_scan_swar"] + counts["ffd_scan_f32"] > 0,
          f"fleet drill 3x: {fleet_report}")
    del fleet_drill
    # 3y: the profiler. Two ticks of the drill's world with
    # jax_profiler_dir set (tools/drill_probe.profile_doc): a scale-up of
    # pods of distinct sizes through K2 and a scale-down, the journal's
    # probe (K4 and its rows on the factored 30 000 x 1 000 snapshot) on
    # both; the same run unprofiled: the decisions equal, each profiled
    # tick's session a Chrome trace naming its kernels, the estimator's
    # range and the tick's step, the kernels' launches correlated under
    # their ranges
    plain_drill, _ = drill_probe.run_drill(drill_probe.profile_doc(), dev,
                                         profile_ticks=drill_probe.PROFILE_TICKS)
    prof_dir = os.path.join(root, "build", "profiles")
    shutil.rmtree(prof_dir, ignore_errors=True)
    (profiled, _), counts, _ = run_path("profiled drill 3y", lambda: drill_probe.run_drill(
        drill_probe.profile_doc(), dev, profiler_dir=prof_dir,
        profile_ticks=drill_probe.PROFILE_TICKS))
    check(drill_probe.comparable(profiled) == drill_probe.comparable(plain_drill),
          "profiled drill 3y: the decisions differ from the unprofiled run's")
    check(counts["ffd_scan_swar"] > 0 and counts["fit_reduce"] > 0,
          f"profiled drill 3y: K2 and K4 did not both launch: {counts}")
    sessions = drill_probe.profile_sessions(profiled, prof_dir)
    for sess in sessions:
        print(f"# profiled drill 3y: {json.dumps(sess, sort_keys=True)}", flush=True)
    bad = drill_probe.session_problems(sessions)
    check(not bad, f"profiled drill 3y: {bad}")
    for rec, plain_rec in zip(profiled.records, plain_drill.records):
        print(f"# profiled drill 3y: tick {rec.tick} {rec.wall_s:.4f} s "
              f"{'profiled' if rec.tick in drill_probe.PROFILE_TICKS else 'not profiled'} "
              f"against {plain_rec.wall_s:.4f} s unprofiled", flush=True)
    del profiled, plain_drill
    # 3z: the Vertical Pod Autoscaler (tools/vpa_probe) over the snapshot
    # probe's cluster at a tenth (its full size is tools/vpa_probe's run),
    # its banks on the card: the warm start from 8 days of hourly history
    # for all 10 000 pods (1.92 M CPU samples, the memory peaks) and five
    # live passes over every pod, each a VpaRunner.run_once (scrape,
    # recommend, statuses, checkpoints, evictions) on an in-memory API;
    # every sample batch through K5
    vpa_world = vpa_probe.vpa_world(**vpa_probe.TENTH)
    vpa_capture = []
    vpa_card, counts, t_vpa = run_path("vpa 3z", lambda: vpa_probe.run_vpa(
        vpa_world, dev, capture=vpa_capture))
    print(f"# vpa 3z: {json.dumps(vpa_probe.summary(vpa_card), sort_keys=True)}", flush=True)
    bad = vpa_probe.problems(vpa_card)
    check(not bad, f"vpa 3z: {bad}")
    check(counts["ordered_scatter_add"] >= 4 and len(vpa_capture) == 4,
          f"vpa 3z: K5 launched {counts['ordered_scatter_add']} times, "
          f"{len(vpa_capture)} in the warm start")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main paths")
    check(
        sum(len(p) for _, p in burst_card.values()) > 0 and choice_card[0] is not None,
        "the burst estimate scheduled nothing",
    )
    for variant, ((out, choice), _, _) in spread_card.items():
        check(sum(len(p) for _, p in out.values()) > 0 and choice[0] is not None,
              f"the {variant} spread world scheduled nothing")
    print(f"# main paths: launches {launches}", flush=True)
    phase("3 main paths", t3)

    # -- 4. kernels against their plain versions, results against the CPU ----
    t4 = time.perf_counter()
    kernels = []
    for name, args, res, replaces in (
        ("ffd_scan_swar", headline, res_swar, "autoscaler_tpu/ops/pallas_binpack.py:305"),
        ("ffd_scan_f32", headline_frac, res_f32, "autoscaler_tpu/ops/pallas_binpack.py:141"),
    ):
        ops = ffd_scan.prepare_scan(*args[:3], HEADLINE_MAX_NODES, args[3])
        check((ops.plan is not None) == (name == "ffd_scan_swar"), f"{name}: wrong route")
        NP = ops.stream.shape[2]
        plain_args = (ops.stream, ops.allocs, ops.caps) + (
            (ops.guards,) if ops.plan is not None else ()
        ) + (HEADLINE_MAX_NODES,)
        plain_fn = (
            ffd_scan._scan_plain_swar if ops.plan is not None else ffd_scan._scan_plain_f32
        )
        kernel_fn = ffd_scan.ffd_scan_swar if ops.plan is not None else ffd_scan.ffd_scan_f32

        got = kernel_fn(*plain_args)
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        want = plain_fn(*plain_args, stats=stats)
        torch.cuda.synchronize()
        log(f"{name}: plain version with work count {time.perf_counter() - t0:.1f} s")
        max_err = 0.0
        for field, a, b in zip(("free", "opened", "placed"), want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"{name}: {field} layout")
            check(torch.equal(a, b), f"{name}: {field} differs from the plain version")
            max_err = max(max_err, float((a.double() - b.double()).abs().max()))
        plain_res = ffd_scan.finish_scan(ops, *want)
        for field, a, b in zip(plain_res._fields, plain_res, res):
            check(torch.equal(a, b), f"{name}: main-path {field} differs from the plain version")

        # timings: the kernel alone, the whole entry call, the plain version,
        # and the kernel on an all-zero stream (every pod fits node 0: a
        # step is one summary pass, one round and a placement), the floor of
        # its chain of dependent steps
        ms = event_ms(lambda: kernel_fn(*plain_args))
        call_ms = event_ms(
            lambda: ffd_scan.ffd_binpack_groups_cuda(*args[:3], HEADLINE_MAX_NODES, args[3])
        )
        plain_ms = event_ms(lambda: plain_fn(*plain_args), reps=1)
        zeros = torch.zeros_like(ops.stream)
        floor_ms = event_ms(lambda: kernel_fn(zeros, *plain_args[1:]))
        del zeros

        P_pad = ops.stream.shape[1]
        steps = G * P_pad
        bytes_moved = (
            ops.stream.numel() * 4 + ops.allocs.numel() * 4 + ops.caps.numel() * 4
            + (NP * 4 if ops.plan is not None else 0)
            + G * NP * HEADLINE_MAX_NODES * 4 + G * 4 + G * P_pad
        )
        ops_per_plane = 4 if ops.plan is not None else 1   # or, sub, and, cmp | cmp
        operations = fit_tests(stats) * NP * ops_per_plane
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = operations / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "autoscaler_tpu_torch/csrc/ffd_scan.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "call_ms": call_ms,
            "chain_floor_ms": floor_ms,
            "us_per_step": ms * 1e3 / P_pad,
        })
        print(
            f"# {name}: {ms:.3f} ms kernel ({ms * 1e3 / P_pad:.4f} us a step), "
            f"{call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain, chain floor "
            f"{floor_ms:.3f} ms ({floor_ms * 1e3 / P_pad:.4f} us a step), parity exact "
            f"on all {G} groups", flush=True,
        )
        # the launch geometry (the shared memory from the kernel library
        # itself), and the search the data needs, as the plain version counts it
        print(
            f"# {name} launch: {G} blocks (one a group) of {ffd_scan.GROUP_WARPS} warps, "
            f"{ffd_scan.smem_bytes(NP, HEADLINE_MAX_NODES)} B dynamic shared memory a "
            f"block; {search_line(stats, steps, P_pad)}", flush=True,
        )
        # the bound's inputs, computed from this run's shapes and data
        print(
            f"# {name} bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({kernels[-1]['bound_by']}): G={G} P={P} P_pad={P_pad} planes={NP} "
            f"max_nodes={HEADLINE_MAX_NODES}, {bytes_moved} B moved ({bytes_ms:.4f} ms), "
            f"min({stats['node_tests']} node tests, {stats['summary_tests']} summary tests "
            f"+ {NODE_BLOCK} x {stats['candidate_blocks']} candidate blocks) = "
            f"{fit_tests(stats)} fit tests "
            f"x {NP} planes x {ops_per_plane} = {operations} operations ({ops_ms:.4f} ms)",
            flush=True,
        )
        del ops, got, want, plain_res
    phase("4a K1/K2 against their plain versions", t4)

    # K3 on its three main-path launches: the affinity workload (all 100
    # groups and all 20k pods), and the operands that the two spread worlds'
    # estimate_many handed it (S = 32: the only launches where the spread
    # gates and count planes run; all 16 groups). Each against its plain
    # version with the search counts of the data, then timed, with its
    # chain floor (all-zero requests and bits: every pod on node 0, a step
    # is one summary pass, one round and a placement)
    aff_prep = ffd_scan_affinity.prepare_scan_aff(**aff_ops, max_nodes=AFFINITY_MAX_NODES)
    aff_got = ffd_scan_affinity.ffd_scan_aff(aff_prep)
    torch.cuda.synchronize()
    k3_launches = [("affinity workload", aff_prep, aff_got, res_aff, None)] + [
        (f"{variant} spread world", *captured[variant], None, spread_card[variant][2])
        for variant in spread_worlds
    ]
    for label, ops, got, main_res, host_s in k3_launches:
        t0 = time.perf_counter()
        G_k, P_pad_k, R_k = ops.stream.shape
        M_k = ops.max_nodes
        plain_args = (ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl, ops.spstat,
                      ops.num_planes, ops.num_spread, M_k)
        stats = {}
        want = ffd_scan_affinity._scan_plain_aff(*plain_args, stats=stats)
        torch.cuda.synchronize()
        log(f"ffd_scan_aff ({label}): plain version with work count "
            f"{time.perf_counter() - t0:.1f} s")
        max_err = 0.0
        for field, a, b in zip(("free", "opened", "placed"), want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"ffd_scan_aff ({label}): {field} layout")
            check(torch.equal(a, b), f"ffd_scan_aff ({label}): {field} differs from the plain version")
            max_err = max(max_err, float((a.double() - b.double()).abs().max()))
        if main_res is not None:
            plain_res = ffd_scan_affinity.finish_scan_aff(ops, *want)
            for field, a, b in zip(plain_res._fields, plain_res, main_res):
                check(torch.equal(a, b),
                      f"ffd_scan_aff ({label}): main-path {field} differs from the plain version")
            del plain_res
        ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(ops))
        zeros = ops._replace(stream=torch.zeros_like(ops.stream), bits=torch.zeros_like(ops.bits))
        floor_ms = event_ms(lambda: ffd_scan_affinity.ffd_scan_aff(zeros))
        del zeros, want
        bytes_moved = sum(
            x.numel() * 4 for x in (ops.stream, ops.bits, ops.allocs, ops.caps, ops.nl, ops.hl,
                                    ops.spstat) if x is not None
        ) + G_k * R_k * M_k * 4 + G_k * 4 + G_k * P_pad_k
        operations = k3_operations(stats, R_k)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = operations / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        if main_res is not None:
            call_ms = event_ms(lambda: ffd_scan_affinity.ffd_binpack_groups_affinity_cuda(
                **aff_ops, max_nodes=AFFINITY_MAX_NODES
            ))
            plain_ms = event_ms(lambda: ffd_scan_affinity._scan_plain_aff(*plain_args), reps=1)
            extra = f", {call_ms:.3f} ms whole call, {plain_ms:.1f} ms plain"
            kernels.append({
                "name": "ffd_scan_aff",
                "route": "cuda",
                "source": "autoscaler_tpu_torch/csrc/ffd_scan_affinity.cu",
                "replaces": "autoscaler_tpu/ops/pallas_binpack_affinity.py:150",
                "launches": launches["ffd_scan_aff"],
                "max_abs_err": max_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
                "call_ms": call_ms,
                "chain_floor_ms": floor_ms,
                "us_per_step": ms * 1e3 / P_pad_k,
            })
        else:
            extra = f"; estimate_many + least-waste {host_s:.3f} s host clock"
        print(
            f"# ffd_scan_aff on the {label}: {ms:.3f} ms kernel "
            f"({ms * 1e3 / P_pad_k:.4f} us a step), chain floor {floor_ms:.3f} ms "
            f"({floor_ms * 1e3 / P_pad_k:.4f} us a step), parity exact on all {G_k} groups"
            f"{extra}", flush=True,
        )
        # the launch geometry (the shared memory from the kernel library
        # itself), and the search the data needs, as the plain version counts it
        smem = ffd_scan_affinity.affinity_smem_bytes(R_k, ops.num_planes, ops.num_spread, M_k)
        print(
            f"# ffd_scan_aff launch on the {label}: {G_k} blocks (one a group) of "
            f"{ffd_scan_affinity.GROUP_WARPS} warps ({ffd_scan_affinity.WARP_BLOCKS} candidate "
            f"blocks a warp a round), {smem} B dynamic shared memory a block; "
            f"{search_line(stats, G_k * P_pad_k, P_pad_k)}", flush=True,
        )
        # the bound's inputs, computed from this run's shapes and data
        print(
            f"# ffd_scan_aff bound on the {label} {bound_ms:.4f} ms ({bound_by}): G={G_k} "
            f"P_pad={P_pad_k} R={R_k} planes={ops.num_planes} bit_planes={ops.bits.shape[2]} "
            f"S={ops.num_spread} max_nodes={M_k}, {bytes_moved} B moved ({bytes_ms:.4f} ms), "
            f"{k3_work(stats, R_k)} = {operations} operations ({ops_ms:.4f} ms); "
            f"{ms / bound_ms:.1f}x the bound", flush=True,
        )
        phase(f"4b K3 on the {label} against its plain version", t0)
    del aff_got, k3_launches, captured
    # 4v's CPU sides begin now in workers, after the phases whose plain
    # versions the host's cores pace
    for name, _ in canned.scenario_docs():
        cpu_jobs[f"canned 4v {name}"] = _POOL.apply_async(cpu_canned, (name,))

    # the estimator's results and choices against the same calls on the
    # CPU (4c-4d), read from the workers begun after the operand set-up
    def from_cpu(label, pods_w):
        """A worker's estimate → (its seconds, {group: (count, pods)}),
        the pods this process's own by name; the wait is the phase's."""
        secs, named = cpu_jobs[label].get(CPU_WAIT_S)
        by_name = {p.name: p for p in pods_w}
        return secs, {g: (c, [by_name[n] for n in names]) for g, (c, names) in named.items()}

    t0 = time.perf_counter()
    burst_s, burst_cpu = from_cpu("burst", burst)
    choice_cpu = choose(burst_cpu, templates)
    replicated_s, replicated_cpu = from_cpu("replicated", replicated)
    log(f"estimator on the CPU: burst {burst_s:.1f} s, replicated {replicated_s:.1f} s "
        f"in a worker")
    for label, on_card, on_cpu in (
        ("burst", burst_card, burst_cpu), ("replicated", replicated_card, replicated_cpu)
    ):
        for g in templates:
            check(on_card[g][0] == on_cpu[g][0], f"{label} {g}: node count differs")
            check(
                [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]],
                f"{label} {g}: scheduled pods differ",
            )
    check(choice_card == choice_cpu, "the expander chose differently on the card")
    print(
        f"# estimator: card equals CPU on {len(templates)} groups (burst and "
        f"replicated), least-waste picks {choice_card[0]}; on the CPU (torch loops, a "
        f"worker of {CPU_WORKER_THREADS} threads): burst {burst_s:.3f} s, replicated "
        f"{replicated_s:.3f} s", flush=True,
    )
    phase("4c plain-route estimates on the CPU", t0)

    def compare_sampled(label, pods_w, tmpl_w, on_card, stride, on_cpu=None):
        """The CPU's estimate on every ``stride``-th template (a worker's,
        or ``on_cpu``) against the card's results for those templates, and
        the least-waste choice among them."""
        t0 = time.perf_counter()
        sample = sampled(tmpl_w, stride)
        secs, on_cpu = from_cpu(label, pods_w) if on_cpu is None else (None, on_cpu)
        check(set(on_cpu) == set(sample), f"{label}: the CPU estimated other templates")
        for g in sample:
            check(on_card[g][0] == on_cpu[g][0], f"{label} {g}: node count differs")
            check(
                [p.name for p in on_card[g][1]] == [p.name for p in on_cpu[g][1]],
                f"{label} {g}: scheduled pods differ",
            )
        card_sample = {g: on_card[g] for g in sample}
        check(choose(card_sample, sample) == choose(on_cpu, sample),
              f"{label}: the expander chose differently on the card")
        print(
            f"# {label}: card equals CPU on {len(sample)} of {len(tmpl_w)} templates, "
            f"{sum(c for c, _ in on_card.values())} nodes on the card in all, "
            f"least-waste picks {choose(on_card, tmpl_w)[0]} (all) and "
            f"{choose(card_sample, sample)[0]} (sample)"
            + (f"; {secs:.3f} s on the CPU in a worker" if secs is not None else ""),
            flush=True,
        )
        phase(f"4d {label} on the CPU", t0)

    for variant, (pods_sw, tmpl_sw) in spread_worlds.items():
        (out, _choice), _, _ = spread_card[variant]
        compare_sampled(f"{variant} spread world", pods_sw, tmpl_sw, out, CPU_TEMPLATE_STRIDE)
    compare_sampled("replicated affinity world", replicated_aff, templates,
                    replicated_aff_card, CPU_RUNS_TEMPLATE_STRIDE)
    for ports, (pods_g, tmpl_g) in gate_worlds.items():
        compare_sampled(f"plain-route gate world ({3 + ports} planes)", pods_g, tmpl_g,
                        gate_card[ports], 1,
                        BinpackingNodeEstimator(gate_limiter, device="cpu").estimate_many(
                            pods_g, tmpl_g))

    # K4 against its plain version on the card: the tiled fit's main-path
    # launch on all 100k pods, and the probe's two launches on the operands
    # they were handed
    t0 = time.perf_counter()

    def hold(label, want, got):
        """Every field equal, dtype and all; → the largest difference (0)."""
        err = 0.0
        for field, a, b in zip(want._fields, want, got):
            check(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {field} layout")
            check(torch.equal(a, b), f"{label}: {field} differs from the plain version")
            err = max(err, float((a.double() - b.double()).abs().max()))
        return err

    fit_stats, probe_stats, rows_stats = {}, {}, {}
    max_err = hold("fit_reduce (fit-K4)", fit_reduce._fit_reduce_plain(*fit_ops, stats=fit_stats),
                   res_fit)
    for k, (operands, got) in enumerate(probe_launches):
        max_err = max(max_err, hold(
            f"fit_reduce (probe launch {k})",
            fit_reduce._fit_reduce_plain(*operands, stats=probe_stats if k == 0 else None), got,
        ))
    rows_err = 0.0
    for k, (operands, got) in enumerate(rows_launches):
        rows_err = max(rows_err, hold(
            f"fit_reduce_rows (probe launch {k})",
            fit_reduce._fit_reduce_rows_plain(*operands, stats=rows_stats if k == 0 else None), got,
        ))
    ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*fit_ops))
    plain_ms = event_ms(lambda: fit_reduce._fit_reduce_plain(*fit_ops), reps=1)
    probe_ops = probe_launches[0][0]
    probe_k4_ms = event_ms(lambda: fit_reduce.fit_reduce_cuda(*probe_ops))
    rows_ops = rows_launches[0][0]
    rows_ms = event_ms(lambda: fit_reduce.fit_reduce_rows(*rows_ops))
    rows_plain_ms = event_ms(lambda: fit_reduce._fit_reduce_rows_plain(*rows_ops), reps=1)
    call_ms = event_ms(lambda: fit_reduce.fit_reduce_exact(probe_t))
    P_f, R_f = fit_ops[0].shape
    N_f = fit_ops[1].shape[0]
    CP_f, CN_f = fit_ops[4].shape
    # operands read once (f32 rows, i32 classes, bool mask and validity),
    # outputs written once (bool, i32, i32); the operations: a class test a
    # live pair, and the compares of each pair that passes it up to the first
    # that fails, on the resources that can fail in its (block, tile) only
    # (the fewer of the plain and the pruned count: see _fit_reduce_plain)
    bytes_moved = (P_f * R_f * 4 + N_f * R_f * 4 + P_f * 4 + N_f * 4 + CP_f * CN_f + N_f
                   + P_f * (1 + 4 + 4))
    operations = fit_stats["class_tests"] + fit_stats["live_compares"]
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / FP32_OPS_PER_S * 1e3
    kernels.append({
        "name": "fit_reduce",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/fit_reduce.cu",
        "replaces": "autoscaler_tpu/ops/pallas_fit.py:78",
        "launches": launches["fit_reduce"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "call_ms": call_ms,
    })
    # the rows entry on the probe's special rows: the slots read once, and
    # for the real slots alone their R requests and [N] bool rows (padding
    # slots are never read); the outputs written once
    S_r, R_r = rows_ops[0].shape
    N_r = rows_ops[1].shape[0]
    real_r = int((rows_ops[3] >= 0).sum())
    rows_bytes = (real_r * R_r * 4 + N_r * R_r * 4 + real_r * N_r + S_r * 4
                  + S_r * (1 + 4 + 4))
    rows_operations = rows_stats["row_tests"] + rows_stats["live_compares"]
    rows_bytes_ms = rows_bytes / HBM_BYTES_PER_S * 1e3
    rows_ops_ms = rows_operations / FP32_OPS_PER_S * 1e3
    kernels.append({
        "name": "fit_reduce_rows",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/fit_reduce.cu",
        "replaces": "autoscaler_tpu/ops/pallas_fit.py:78",
        "launches": launches["fit_reduce_rows"],
        "max_abs_err": rows_err,
        "ms": rows_ms,
        "plain_ms": rows_plain_ms,
        "bound_ms": max(rows_bytes_ms, rows_ops_ms),
        "bound_by": "bytes" if rows_bytes_ms >= rows_ops_ms else "operations",
        "library_ms": None,
    })
    probe_ops_count = probe_stats["class_tests"] + probe_stats["live_compares"]
    print(
        f"# fit_reduce: {ms:.3f} ms kernel at fit-K4 ({P_f} pods x {N_f} nodes, "
        f"{ms * 1e9 / (P_f * N_f):.4f} ps a pair), {plain_ms:.1f} ms plain, parity exact on "
        f"all {P_f} pods; probe: {probe_k4_ms:.3f} ms kernel, {call_ms:.3f} ms whole "
        f"fit_reduce_exact (exact patch {call_ms - probe_k4_ms:.3f} ms), parity exact on "
        f"both launches ({len(probe_launches)})", flush=True,
    )
    print(
        f"# fit_reduce bound {max(bytes_ms, ops_ms):.4f} ms ({kernels[-2]['bound_by']}): "
        f"P={P_f} N={N_f} R={R_f} CP={CP_f} CN={CN_f}, {bytes_moved} B moved "
        f"({bytes_ms:.4f} ms), {fit_stats['class_tests']} class tests + "
        f"min({fit_stats['compares']} compares, {fit_stats['live_compares']} on live "
        f"resources) = {operations} operations ({ops_ms:.4f} ms); "
        f"{ms / max(bytes_ms, ops_ms):.2f}x the bound; probe launch: "
        f"{probe_stats['class_tests']} class tests + min({probe_stats['compares']} "
        f"compares, {probe_stats['live_compares']} on live resources) = {probe_ops_count} "
        f"operations ({probe_ops_count / FP32_OPS_PER_S * 1e3:.4f} ms at the peak rate; "
        f"{probe_k4_ms / max(bytes_ms, probe_ops_count / FP32_OPS_PER_S * 1e3):.2f}x)",
        flush=True,
    )
    print(
        f"# fit_reduce_rows: {rows_ms:.3f} ms kernel on the probe's {S_r} special slots "
        f"({real_r} pods) x "
        f"{N_r} nodes (R={R_r}), {rows_plain_ms:.1f} ms plain, parity exact on both launches "
        f"({len(rows_launches)}); bound {max(rows_bytes_ms, rows_ops_ms):.4f} ms "
        f"({kernels[-1]['bound_by']}): {rows_bytes} B moved ({rows_bytes_ms:.4f} ms), "
        f"{rows_stats['row_tests']} row tests + min({rows_stats['compares']} compares, "
        f"{rows_stats['live_compares']} on live resources) = {rows_operations} operations "
        f"({rows_ops_ms:.4f} ms); {rows_ms / max(rows_bytes_ms, rows_ops_ms):.2f}x the bound",
        flush=True,
    )
    # the launch geometry and shared memory (from the kernel library), the
    # registers (ptxas), the live resources a (block, tile) the data leaves,
    # and the SASS instructions a pair of the inner loops
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sm_hz = float(smi_clock) * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, ops_l, stats_l in (("fit-K4", fit_ops, fit_stats),
                                  ("probe", probe_ops, probe_stats)):
        P_l, R_l = ops_l[0].shape
        N_l = ops_l[1].shape[0]
        CP_l, CN_l = ops_l[4].shape
        gx, gy, per_sm = fit_reduce.launch_geometry(P_l, N_l, R_l, CP_l, CN_l)
        print(
            f"# fit_reduce launch at {label}: grid {gx} x {gy} blocks of 128 threads "
            f"({per_sm} resident an SM, {sms} SMs), "
            f"{fit_reduce.smem_bytes(R_l, CP_l, CN_l)} B dynamic shared memory a block; "
            f"live resources a (block, tile): {stats_l['live_counts']}", flush=True,
        )
    gx, gy, per_sm = fit_reduce.launch_geometry(S_r, N_r, R_r, rows=True)
    print(f"# fit_reduce_rows launch: grid {gx} x {gy} ({per_sm} resident an SM), "
          f"{fit_reduce.rows_smem_bytes(R_r)} B dynamic shared memory a block", flush=True)
    for line in k4_registers(_build.BUILD_LOGS["fit_reduce"]):
        print(f"# fit_reduce.cu {line}", flush=True)
    loops = k4_sass_loops(_build.build("fit_reduce")["fit_reduce"])
    pairs = P_f * N_f
    for nl, (per_pair, alu_per_pair) in sorted(loops.items()):
        print(
            f"# fit_reduce SASS inner loop at {nl} live resources: {per_pair:.3f} instructions "
            f"a pair, {alu_per_pair:.3f} on the ALU pipe; floor at fit-K4's {pairs} pairs "
            f"({sms} SMs at {smi_clock} MHz): issue {pairs * per_pair / (sms * 128 * sm_hz) * 1e3:.4f}"
            f" ms, ALU pipe {pairs * alu_per_pair / (sms * 64 * sm_hz) * 1e3:.4f} ms", flush=True,
        )
    phase("4e K4 against its plain version", t0)

    # the probe's exact reduction on every pod row against an independent
    # dense path: dense_sched() expands classes, exception rows and cells
    # itself, and the reduction runs over it chunked by pods
    t0 = time.perf_counter()
    exact = fit_reduce.fit_reduce_exact(probe_t)
    dense = probe_t.dense_sched()
    free_d = probe_t.free()
    ref_parts = []
    for s0 in range(0, probe_t.num_pods, 2048):
        rows = slice(s0, s0 + 2048)
        fits = (probe_t.pod_req[rows, None, :] <= free_d[None, :, :]).all(dim=2)
        fits &= dense[rows] & probe_t.pod_valid[rows, None] & probe_t.node_valid[None, :]
        cnt = fits.sum(dim=1, dtype=torch.int32)
        first = fits.to(torch.uint8).argmax(dim=1).to(torch.int32)   # the first max
        ref_parts.append((cnt > 0, cnt, torch.where(cnt > 0, first, -1)))
    ref = fit_reduce.FitReduction(*(torch.cat(x) for x in zip(*ref_parts)))
    del dense, ref_parts
    for field, a, b in zip(ref._fields, ref, exact):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"probe: fit_reduce_exact {field} differs from the dense path")
    check(torch.equal(probe_first, ref.first_fit), "probe: first_fit_node differs from the dense path")
    ref_any = ref.any_fit.cpu().numpy()
    fitting = sorted(p.key() for p in world_pending if ref_any[probe_meta.pod_index[p.key()]])
    check(sorted(payload["pending_pods_fitting_free_capacity"]) == fitting,
          "probe: the capture's fitting pods differ from the dense path")
    print(
        f"# probe: fit_reduce_exact equals the dense path on all {probe_t.num_pods} pod "
        f"rows ({int(ref.any_fit.sum())} fit somewhere, "
        f"{int(ref.fit_count.sum())} fitting pairs)", flush=True,
    )
    # the exact patch in parts: the static special slots, their true rows,
    # the rows entry, and the scatter over K4's result
    E_p, K_p = probe_t.exc_rows.shape[0], probe_t.cell_pod.shape[0]
    special = fit_reduce.special_pods(probe_t)
    srows = fit_reduce.special_rows(probe_t)
    sreq = probe_t.pod_req[special.clamp(min=0)]
    slots = special.to(torch.int32)
    part = fit_reduce.fit_reduce_rows(sreq, free_d, srows, slots)
    base = fit_reduce.fit_reduce_cuda(*probe_ops)
    parts_ms = {
        "slots": event_ms(lambda: fit_reduce.special_pods(probe_t)),
        "row build": event_ms(lambda: fit_reduce.special_rows(probe_t)),
        "request gather": event_ms(lambda: probe_t.pod_req[special.clamp(min=0)]),
        "fit and reduction (rows entry)": event_ms(lambda: fit_reduce.fit_reduce_rows(
            sreq, free_d, srows, slots)),
        "scatter": event_ms(lambda: fit_reduce.patch_reduction(
            base, special, part, probe_t.pod_valid)),
        "free": event_ms(probe_t.free),
    }
    print(
        f"# probe exact patch: S = E + K = {E_p} + {K_p} = {E_p + K_p} slots "
        f"({int((special >= 0).sum())} pods), {N_r} nodes; "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts_ms.items())
        + f"; sum {sum(parts_ms.values()):.4f} ms; whole call {call_ms:.3f} ms = K4 "
        f"{probe_k4_ms:.3f} ms + {call_ms - probe_k4_ms:.3f} ms", flush=True,
    )
    del special, srows, sreq, slots, part, base
    phase("4f the probe against a dense path", t0)

    # both ticks again on ClusterSnapshots on the CPU, of the same objects
    # (in workers): every filtered key and assignment, the snapshot after
    # the revert, the whole ScaleUpResult and the provider afterwards must
    # be equal
    for label in ("3j", "3k"):
        t0 = time.perf_counter()
        cpu_rec = cpu_jobs[f"tick {label}"].get(CPU_WAIT_S)
        on_cpu, on_card = cpu_rec["out"], tick_card[label]["out"]
        diff = tick_probe.tick_differences(on_card, on_cpu)
        check(not diff, f"tick {label}: {diff} differ from the CPU")
        print(
            f"# tick {label}: card equals CPU: {len(on_cpu['filtered'])} filtered keys and "
            f"their assignments, {len(on_cpu['still'])} still pending, the snapshot after "
            f"revert, the whole ScaleUpResult ({cpu_rec['chosen_group']} "
            f"+{cpu_rec['new_nodes']}) and {len(on_cpu['sizes'])} target sizes; on "
            f"the CPU (a worker): pack {cpu_rec['pack_s']:.3f} s, filter-out "
            f"{cpu_rec['filter_s']:.3f} s, scale_up {cpu_rec['scale_up_s']:.3f} s", flush=True,
        )
        phase(f"4g tick {label} on the CPU", t0)

    # the tick sequence: tick 2's tensors against a full pack of the same
    # objects on the card, by pod key and node name; then the sequence
    # replayed on the CPU through a packer of its own (tick 1 its update
    # alone: 4g ran the whole tick on this listing), ticks 2 and 3 whole
    t4h = t0 = time.perf_counter()
    nodes_2, pods_2, _, rec_2 = seq[1]
    full_2, full_meta_2 = tick_probe.listing_snapshot(nodes_2, pods_2, dev).tensors()
    diff = tick_probe.tensors_differences(rec_2["tensors"], rec_2["meta"], full_2, full_meta_2)
    check(not diff, f"tick sequence: tick 2's tensors differ from a full pack in {diff}")
    print(f"# sequence tick 2: tensors equal a full pack of its listing by pod key and node "
          f"name (mask verdicts of all {full_meta_2.num_pods} pods, requests, allocatables, "
          f"used, groups, assignments); the full pack {time.perf_counter() - t0:.3f} s "
          f"with the comparison", flush=True)
    del full_2, full_meta_2
    for k, ((nodes_k, pods_k, _, rec), (secs, cpu_rec)) in enumerate(
            zip(seq, cpu_jobs["sequence"].get(CPU_WAIT_S))):
        if k == 0:
            print(f"# sequence tick 1 on the CPU: the packer's update {secs:.3f} s host clock "
                  f"(a worker)", flush=True)
            continue
        diff = tick_probe.tick_differences(rec["out"], cpu_rec["out"])
        check(not diff, f"tick sequence: tick {k + 1} differs from the CPU in {diff}")
        check(cpu_rec["packer"] == rec["packer"],
              f"tick sequence: tick {k + 1}'s packer counts differ from the CPU's")
        print(f"# sequence tick {k + 1}: card equals CPU ({len(cpu_rec['out']['filtered'])} "
              f"filtered, {len(cpu_rec['out']['still'])} still pending, the whole "
              f"ScaleUpResult); on the CPU (a worker): {secs:.3f} s host clock, pack "
              f"{cpu_rec['pack_s']:.3f} s", flush=True)
    _POOL.close()
    phase("4h the tick sequence against a full pack and on the CPU", t4h)

    # the resident arena: a second packer with a DeviceArena on the card
    # replays the three listings (packer updates only); what it serves must
    # equal the first packer's tensors bit for bit (they stay valid: that
    # packer uploads anew what changed), tick 1 seeds, ticks 2 and 3 apply
    # deltas with no full upload, and nothing rolls back
    t0 = time.perf_counter()
    arena = DeviceArena(device=dev)
    arena_packer = IncrementalPacker(arena=arena, device=dev)
    real_apply = arena.apply
    apply_ms = []

    def timed_apply(program):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_apply(program)
        stop.record()
        apply_ms.append((start, stop))
        return out

    arena.apply = timed_apply
    for k, (nodes_k, pods_k, _, rec) in enumerate(seq):
        t1 = time.perf_counter()
        served, served_meta = tick_probe.listing_snapshot(
            nodes_k, pods_k, dev, arena_packer).tensors()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t1
        start, stop = apply_ms[-1]
        stats = arena.take_stats()
        diff = tick_probe.fields_differing(served, rec["tensors"])
        check(not diff and served_meta.pod_index == rec["meta"].pod_index
              and served_meta.node_index == rec["meta"].node_index,
              f"arena: tick {k + 1}'s served tensors differ from the packer's in {diff}")
        check(served.pod_req.device == dev, f"arena: tick {k + 1} served off the card")
        check(stats["rollbacks"] == 0, f"arena: tick {k + 1} rolled back: {stats}")
        check((stats["full_uploads"] > 0) == (k == 0) and stats["promotions"] == int(k == 0),
              f"arena: tick {k + 1} {'did not seed' if k == 0 else 'uploaded in full'}: {stats}")
        print(f"# arena tick {k + 1}: update {host_s:.3f} s host clock, apply span on the card "
              f"{start.elapsed_time(stop):.3f} ms (CUDA events), stats {stats}, clones "
              f"{arena.clones}, served tensors equal the packer's bit for bit", flush=True)
        del served, served_meta
    arena.apply = real_apply
    del arena_packer, arena
    phase("4i the arena replay", t0)

    # 3m again on the CPU through a planner and actuator of its own, field
    # for field; 3n's removal dispatch on 256 seeded lanes (lanes are
    # independent) and its joint pass whole, on the CPU from the same operands
    t0 = time.perf_counter()
    listing, options_kw = down_listings["3m"]
    cpu_rec = scaledown_probe.run_scale_down(*listing, "cpu", options_kw)
    on_card, on_cpu = down_card["3m"]["out"], cpu_rec["out"]
    diff = scaledown_probe.scaledown_differences(on_card, on_cpu)
    fields = sum(len(lp) for lp in on_cpu["loops"]) + len(on_cpu["actuation"])
    utils = sum(len(lp["utilization"]) for lp in on_cpu["loops"])
    print(f"# scale-down 3m: card against CPU: {len(on_cpu['loops'])} loops and the "
          f"actuation, {fields} fields ({utils} utilizations bit for bit, "
          f"{sum(len(lp['plan']['unremovable']) for lp in on_cpu['loops'])} unremovable "
          f"reasons); first difference {diff[0] if diff else None}; on the CPU "
          f"{time.perf_counter() - t0:.3f} s host clock", flush=True)
    check(not diff, f"scale-down 3m: the card differs from the CPU in {diff}")
    del cpu_rec
    phase("4j scale-down 3m on the CPU", t0)
    t0 = time.perf_counter()
    lanes, fields, first = scaledown_probe.cpu_lanes_check(down_card["3n"]["loops"][-1]["dispatch_ops"])
    print(f"# scale-down 3n: removal dispatch, {lanes} lanes x {fields} fields on the CPU "
          f"against the card; first difference {first}", flush=True)
    check(first is None, f"scale-down 3n: lanes differ from the CPU at {first}")
    drains, fields, first = scaledown_probe.cpu_joint_check(down_card["3n"]["loops"][-1]["joint_ops"])
    print(f"# scale-down 3n: joint pass, {drains} drains x {fields} fields on the CPU "
          f"against the card; first difference {first}", flush=True)
    check(first is None, f"scale-down 3n: the joint pass differs from the CPU at {first}")
    phase("4k scale-down 3n lanes and joint pass on the CPU", t0)

    # 3o's sequence at a tenth of its size on the card and again on the CPU,
    # tick for tick and field for field (4l)
    t0 = time.perf_counter()
    tenth = loop_probe.loop_world(tenth=True)
    arrive = loop_probe.ARRIVALS // 10
    watch.reset()
    on_card = loop_probe.run_loop_ticks(*tenth, dev, arrive=arrive, replayable=True,
                                        metrics=card_metrics)
    t_card = time.perf_counter() - t0
    check(not watch.problems(), f"reconcile loop 4l: the kernel ladder {watch.problems()}")
    on_cpu = loop_probe.run_loop_ticks(*tenth, "cpu", arrive=arrive, replayable=True)
    diffs = [loop_probe.state_differences(a["state"], b["state"])
             for a, b in zip(on_card["ticks"], on_cpu["ticks"])]
    fields = sum(len(e["state"]) for e in on_cpu["ticks"])
    print(f"# reconcile loop 4l: {len(tenth[0])} nodes, {len(tenth[1])} pods, "
          f"{len(tenth[2])} burst; card against CPU: {len(diffs)} ticks, {fields} fields; "
          f"differences {diffs}; card {t_card:.3f} s, CPU "
          f"{time.perf_counter() - t0 - t_card:.3f} s host clock", flush=True)
    check(len(diffs) == 3 and not any(diffs), f"reconcile loop 4l: the card differs: {diffs}")
    check(all(not e["probe"]["drift"] for e in on_card["ticks"] + on_cpu["ticks"]),
          "reconcile loop 4l: a journal probe found drift")
    tenth_decided = [{**bound_loop.decisions(e["result"]), "unremovable": e["unremovable"]}
                     for e in on_card["ticks"]]
    del on_card, on_cpu
    phase("4l the reconcile loop at a tenth on the card and the CPU", t0)

    # every kernel launch of 3o, at the loop's own shapes, against its plain
    # version on the operands it was handed (4m)
    t0 = time.perf_counter()
    held = loop_probe.hold_launches(loop_capture.launches)
    torch.cuda.synchronize()
    loop_err, loop_shapes = {}, {}
    for k, (name, shape, err, differ) in enumerate(held):
        check(not differ, f"reconcile loop launch {k} ({name} on {shape}): {differ} differ "
              f"from the plain version")
        loop_err[name] = max(loop_err.get(name, 0.0), err)
        loop_shapes.setdefault(name, []).append(shape)
    check(len(held) == sum(loop_capture.counts().values()) > 0,
          "reconcile loop: not every captured launch was held")
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], loop_err.get(entry["name"], 0.0))
    print(f"# reconcile loop 4m: all {len(held)} kernel launches of 3o equal their plain "
          f"versions on the operands they were handed, every field exact; launches and "
          f"operand shapes {loop_shapes}; {time.perf_counter() - t0:.3f} s host clock",
          flush=True)
    del held, loop_capture
    phase("4m the reconcile loop's launches against their plain versions", t0)

    # 3r's ticks (at 4l's size) each decided as 4l's card ticks did, and
    # again on the CPU against fresh fake servers; 3s's gce world in this
    # process on the card and the CPU: every RunOnceResult, target size and
    # recorded write equal (4n)
    t0 = time.perf_counter()
    bound_card = bound
    for k, (entry, want) in enumerate(zip(bound_card["ticks"], tenth_decided)):
        got = {**entry["decisions"], "unremovable": entry["unremovable"]}
        check(got == want, f"bound loop 4n tick {k + 1}: decided {got}, 4l decided {want}")
    watch.reset()
    gce_card = bound_loop.run_gce_in_process(*tenth[:3], dev)
    t_card = time.perf_counter() - t0
    check(not watch.problems(), f"bound loop 4n: the kernel ladder {watch.problems()}")
    bound_cpu = bound_loop.run_bound_ticks(*tenth, "cpu", arrive=arrive, replayable=True)
    gce_cpu = bound_loop.run_gce_in_process(*tenth[:3], "cpu")
    diffs = []
    for k, (a, b) in enumerate(zip(bound_card["ticks"], bound_cpu["ticks"])):
        diffs.append([name for name, x, y in (
            ("result", loop_probe.result_canon(a["result"]), loop_probe.result_canon(b["result"])),
            ("targets", a["targets"], b["targets"]),
            ("writes", bound_loop.write_canon(a["writes"]), bound_loop.write_canon(b["writes"])),
        ) if x != y])
    n_writes = sum(len(e["writes"]) for e in bound_cpu["ticks"])
    gce_same = (gce_card["rc"] == gce_cpu["rc"] == 0 and bound_loop.compute_canon(
        gce_card["compute_writes"]) == bound_loop.compute_canon(gce_cpu["compute_writes"]))
    print(f"# bound loop 4n: {len(tenth[0])} nodes, {len(tenth[1])} pods, {len(tenth[2])} "
          f"burst; card against CPU: {len(diffs)} ticks, {n_writes} writes; differences "
          f"{diffs}; gce in process: {len(gce_cpu['compute_writes'])} compute writes, equal "
          f"{gce_same}; card {t_card:.3f} s, CPU {time.perf_counter() - t0 - t_card:.3f} s "
          f"host clock", flush=True)
    check(len(diffs) == 3 and not any(diffs), f"bound loop 4n: the card differs: {diffs}")
    check(not any(e["decisions"]["errors"] for e in bound_card["ticks"] + bound_cpu["ticks"]),
          "bound loop 4n: a tick failed")
    check(gce_same and any("/resize?" in path for _, path, _ in gce_cpu["compute_writes"]),
          "bound loop 4n: the gce world's compute writes differ, or no resize")
    del bound, bound_card, bound_cpu, gce_card, gce_cpu
    phase("4n the bindings on the card and the CPU", t0)

    # 3t at 4l's tenth on the card and on the CPU (the CPU's in a worker,
    # begun at 3t): every tick's state (result, pods, evictions, decision,
    # journal and SLO lines), preemption summary and the journal's replay
    # verdicts equal (4o)
    t0 = time.perf_counter()
    storm_card_t = storm_card
    card_view = preempt_probe.tick_views(storm_card_t, dev)
    t_card = time.perf_counter() - t0
    t_cpu, cpu_view = cpu_jobs.pop("preempt 4o").get(CPU_WAIT_S)
    diffs = [loop_probe.state_differences(a, b)
             for a, b in zip(card_view["states"], cpu_view["states"])]
    same = {key: card_view[key] == cpu_view[key] for key in ("preemption", "replay")}
    print(f"# preempt 4o: {len(storm_tenth[0])} nodes, {len(storm_tenth[1])} pods, "
          f"{len(storm_tenth[2])} pending; card against CPU: state differences {diffs}, "
          f"equal {same}; passes {card_view['preemption']}; replay divergences "
          f"{[r['divergence'] for r in card_view['replay']]}; card {t_card:.3f} s, CPU "
          f"worker {t_cpu:.3f} s host clock", flush=True)
    check(len(diffs) == 3 and not any(diffs) and all(same.values()),
          f"preempt 4o: the card differs from the CPU: {diffs} {same}")
    check(not any(r["divergence"] for r in card_view["replay"])
          and any(r["replayed"] for r in card_view["replay"]),
          "preempt 4o: the journal replay diverged")
    del storm_card, storm_card_t, storm_tenth
    phase("4o the preemption storm at a tenth on the card and the CPU", t0)

    # the main loop against its plain version ([P, N, R] a step, on the
    # card) and the serial oracle on bench.py's 24 storm worlds (96 pods x
    # 12 nodes) and three worlds of 240 pods x 50 nodes with memory in bytes
    # (4p)
    t0 = time.perf_counter()
    held_storm = preempt_probe.hold_plain(preempt_probe.storm_worlds(), dev)
    held_wide = preempt_probe.hold_plain(preempt_probe.wide_worlds(), dev)
    for label, held in (("4p storm worlds", held_storm), ("4p wide worlds", held_wide)):
        print(preempt_probe.hold_line(label, held), flush=True)
        check(all(h["equal"] for h in held),
              f"preempt {label}: the main loop, its plain version and the oracle differ: "
              f"{[h['differ'] for h in held]}")
    preempt_err = max(h["max_abs_err"] for h in held_storm + held_wide)
    preempt_line = {"name": "torch_preempt", "source": "autoscaler_tpu_torch/ops/preempt.py",
                    "replaces": "autoscaler_tpu/ops/preempt.py:71 (an XLA lax.scan, no "
                                "Pallas kernel)",
                    "dispatches": storm_passes, "worlds": len(held_storm) + len(held_wide),
                    "max_abs_err": preempt_err}
    phase("4p the preemption loop against its plain version and the oracle", t0)

    # 4q: 3v's batched launches against the kernel's plain version on their
    # captured operands; ffd_binpack_scenarios_cuda against its plain
    # version and the serial oracle on small worlds; a fleet of 8 tenants
    # at the 1024x32x8 bucket on the card and on the CPU (the CPU's in a
    # worker begun at 3v); sharded_scaledown_step on a 1-device candidate
    # mesh over 3m's candidates against 3m's passes
    t0 = time.perf_counter()
    held = loop_probe.hold_launches(fleet_out["captured"])
    fleet_err = {}
    for k, (name, shape, err, differ) in enumerate(held):
        check(not differ, f"fleet 4q: batched launch {k} ({name} on {shape}): {differ} differ")
        fleet_err[name] = max(fleet_err.get(name, 0.0), err)
    held_small = fleet_probe.hold_scenarios(fleet_probe.small_worlds(), dev)
    for h in held_small:
        check(h["equal"], f"fleet 4q {h['label']}: {h['differ']}")
        for name in h["route"]:
            fleet_err[name] = max(fleet_err.get(name, 0.0), h["max_abs_err"])
    check([h["route"] for h in held_small] == [["ffd_scan_swar"], ["ffd_scan_swar"],
                                               ["ffd_scan_f32"], ["ffd_scan_f32"]],
          f"fleet 4q: small worlds' routes {[h['route'] for h in held_small]}")
    card_view = fleet_probe.fleet_view(dev)
    t_cpu, cpu_view = cpu_jobs.pop("fleet 4q").get(CPU_WAIT_S)
    same = {key: card_view[key] == cpu_view[key] for key in ("answers", "record", "metrics")}
    check(all(same.values()) and all(r["match_solo"] for r in card_view["record"]["tenants"]),
          f"fleet 4q: the card's fleet differs from the CPU's: {same}")
    from autoscaler_tpu_torch.ops.scaledown import joint_removal_feasibility
    from autoscaler_tpu_torch.parallel.mesh import Mesh, sharded_scaledown_step

    fn, (sd_snap, sd_cands, sd_slots, sd_blocked) = down_card["3m"]["loops"][-1]["dispatch_ops"]
    sd_excluded = torch.zeros(sd_snap.node_valid.shape[0], dtype=torch.bool, device=dev)
    sd_excluded[sd_cands.long()] = True
    per, joint = sharded_scaledown_step(Mesh([dev], ("candidate",)), sd_snap, sd_cands,
                                        sd_slots, sd_blocked, sd_excluded)
    per_ref = fn(sd_snap, sd_cands, sd_slots, sd_blocked)
    joint_ref = joint_removal_feasibility(sd_snap, sd_cands, sd_slots, sd_excluded)
    check(all(torch.equal(a, b) for a, b in zip(per, per_ref))
          and all(torch.equal(a, b) for a, b in zip(joint, joint_ref)),
          "fleet 4q: sharded_scaledown_step differs from 3m's passes")
    for entry in kernels:
        entry["max_abs_err"] = max(entry["max_abs_err"], fleet_err.get(entry["name"], 0.0))
        if entry["name"] == fleet_batch[0]:
            entry["fleet_batch_ms"] = fleet_batch_ms
            entry["fleet_batch_stream"] = list(fleet_batch[1][0].shape)
    print(f"# fleet 4q: all {len(held)} batched launches of 3v equal their plain versions "
          f"({[(n, s) for n, s, _, _ in held]}); small worlds "
          f"{[(h['label'], h['route']) for h in held_small]} equal their plain versions and "
          f"the oracle; the 1024x32x8 fleet on the card and the CPU equal {same} (CPU worker "
          f"{t_cpu:.3f} s); sharded_scaledown_step over 3m's {int(sd_cands.shape[0])} "
          f"candidates equal to its passes ({int(per.feasible.sum())} feasible, "
          f"{int(joint.feasible.sum())} jointly); {time.perf_counter() - t0:.3f} s host clock",
          flush=True)
    del held, fleet_out, card_view, cpu_view
    phase("4q the fleet's launches, small worlds, the CPU's fleet, the mesh's scale-down", t0)

    # 4r: the drill at a tenth on the card and on the CPU (in a worker begun
    # at 3w): the decision logs and the score reports (wall fields aside)
    # byte-equal
    t0 = time.perf_counter()
    drill_tenth, tenth_s = drill_probe.run_drill(drill_probe.drill_doc(tenth=True), dev)
    check(not drill_probe.drill_problems(drill_tenth, tenth=True),
          f"drill 4r: {drill_probe.drill_problems(drill_tenth, tenth=True)}")
    t_cpu, cpu_view = cpu_jobs.pop("drill 4r").get(CPU_WAIT_S)
    card_view = drill_probe.comparable(drill_tenth)
    same = {key: card_view[key] == cpu_view[key] for key in card_view}
    check(all(same.values()), f"drill 4r: the card's run differs from the CPU's: {same}")
    print(f"# drill 4r: {len(drill_tenth.records)} ticks, {tenth_s:.3f} s on the card, "
          f"{t_cpu:.3f} s on the CPU; decision logs and reports equal", flush=True)
    del drill_tenth, cpu_view, card_view
    phase("4r the drill at a tenth on the card and the CPU", t0)

    # 4s: python -m autoscaler_tpu_torch.gym tune over a two-scenario suite
    # at 4r's size on the card and on the CPU (in a worker begun at 3w):
    # the tuning ledgers equal
    t0 = time.perf_counter()
    card_ledger = drill_probe.tune_ledger(drill_probe.gym_suite_doc(), dev)
    t_card = time.perf_counter() - t0
    t_cpu, cpu_ledger = cpu_jobs.pop("tune 4s").get(CPU_WAIT_S)
    check(card_ledger == cpu_ledger and card_ledger.strip(),
          "tune 4s: the card's tuning ledger differs from the CPU's")
    print(f"# tune 4s: {len(card_ledger.splitlines())} generation(s), {t_card:.3f} s on the "
          f"card, {t_cpu:.3f} s on the CPU; ledgers equal", flush=True)
    phase("4s the gym's tune on the card and the CPU", t0)

    # 4t: the VPA on the card and the CPU. 3z's run again on the CPU (in a
    # worker begun at 3w): every recommendation, status write, checkpoint
    # and eviction equal. K5 against its plain version on each of the warm
    # start's four sample batches and on four adversarial worlds, bit for
    # bit; timed on the warm start's batches (tools/k5_bench): the whole
    # call, its grouping and its chains on the largest (the CPU bank's
    # 1.92 M samples), a feed's four targets, and index_add_ on the card
    # (its atomics add a cell's samples in no fixed order: the library
    # call, used nowhere in the port). Then the admission webhook on 3z's
    # recommendations over HTTP, and over HTTPS where the cryptography
    # package imports
    t0 = time.perf_counter()
    t_cpu, cpu_view = cpu_jobs.pop("vpa 4t").get(CPU_WAIT_S)
    card_view = vpa_probe.comparable(vpa_card)
    same = {part: card_view[part] == cpu_view[part] for part in card_view}
    same.update({f"pass {k} {key}": card_view["passes"][k][key] == cpu_view["passes"][k][key]
                 for k in range(len(card_view["passes"])) for key in card_view["passes"][k]})
    check(all(same.values()), f"vpa 4t: the card's run differs from the CPU's: "
          f"{[k for k, v in same.items() if not v]}")
    print(f"# vpa 4t: card {t_vpa:.3f} s (warm start {vpa_card['replay']['seconds']:.3f} s, "
          f"passes {[round(p['seconds'], 3) for p in vpa_card['passes']]} s), CPU {t_cpu:.3f} s; "
          f"every recommendation, status, checkpoint and eviction equal", flush=True)
    max_err = 0.0
    for k, (before, index, values, after) in enumerate(vpa_capture):
        want = ops_histogram._ordered_scatter_add_plain(before.cpu(), index.cpu(), values.cpu())
        got = after.cpu()
        check(torch.equal(want.view(torch.int32), got.view(torch.int32)),
              f"vpa 4t: K5 differs from its plain version on warm-start batch {k}")
        max_err = max(max_err, float((want.double() - got.double()).abs().max()))
    worlds = k5_worlds()
    for label, (target, index, values) in worlds.items():
        want = ops_histogram._ordered_scatter_add_plain(target.clone(), index, values)
        got = ops_histogram.ordered_scatter_add(target.to(dev), index.to(dev), values.to(dev))
        check(torch.equal(want.view(torch.int32), got.cpu().view(torch.int32)),
              f"vpa 4t: K5 differs from its plain version on the {label} world")
        max_err = max(max_err, float((want.double() - got.cpu().double()).abs().max()))
    k5 = k5_bench.measure(vpa_capture, reps=REPS)
    check(k5["equal"], "vpa 4t: K5's timed feed differs from the warm start's")
    before, index, values, _ = max(vpa_capture, key=lambda c: c[1].numel())
    plain_args = (before.cpu(), index.cpu(), values.cpu())
    t1 = time.perf_counter()
    ops_histogram._ordered_scatter_add_plain(*plain_args)
    plain_ms = (time.perf_counter() - t1) * 1e3
    largest = k5["largest"]
    kernels.append({
        "name": "ordered_scatter_add",
        "route": "cuda",
        "source": "autoscaler_tpu_torch/csrc/histogram.cu",
        # not a TPU kernel: the JAX package's scatter-add, which XLA runs
        "replaces": "autoscaler_tpu/vpa/histogram.py:111",
        "tpu_kernel": False,
        "launches": launches["ordered_scatter_add"],
        "max_abs_err": max_err,
        "ms": k5["call_ms"],
        "plain_ms": plain_ms,
        "bound_ms": largest["bound_ms"],
        # the kernels line takes "bytes" or "operations": a chain is Lmax dependent adds
        "bound_by": "bytes" if largest["bound_by"] == "bytes" else "operations",
        "bound_term": largest["bound_by"],
        "library_ms": k5["index_add_ms"],
        "call_ms": k5["call_ms"],
        "group_ms": k5["group_ms"],
        "chain_ms": k5["chain_ms"],
        "feed_ms": k5["feed_ms"],
        "lmax": largest["lmax"],
        "bound_terms_ms": {t: largest[f"{t}_ms"] for t in ("bytes", "operations", "chain")},
        "longest": k5["longest"],
        "one_cell": k5["one_cell"],
    })
    split = {part: (f"{k5[part]:.4f} ms" if isinstance(k5[part], float) else k5[part])
             for part in ("group_ms", "chain_ms")}
    print(f"# ordered_scatter_add: {k5['call_ms']:.4f} ms whole call (grouping "
          f"{split['group_ms']}, chains {split['chain_ms']}, torch.profiler), a feed's four targets "
          f"{k5['feed_ms']:.4f} ms, {k5['index_add_ms']:.4f} ms index_add_ on the card, "
          f"{plain_ms:.1f} ms plain (host clock); parity exact on the warm start's "
          f"{len(vpa_capture)} batches and the worlds {sorted(worlds)}; Lmax {k5['lmax']}; "
          f"bound {largest['bound_ms']:.4f} ms ({largest['bound_by']}): K={largest['pairs']} "
          f"samples into {largest['cells']} cells, bytes {largest['bytes_ms']:.4f} ms, adds "
          f"{largest['operations_ms']:.6f} ms, a chain of {largest['lmax']} adds "
          f"{largest['chain_ms']:.4f} ms; on the batch with the longest run (Lmax "
          f"{k5['longest']['lmax']}) {k5['longest']['call_ms']:.4f} ms against its bound "
          f"{k5['longest']['bound_ms']:.4f} ms ({k5['longest']['bound_by']}); the one-cell "
          f"world of {k5['one_cell']['pairs']} pairs {k5['one_cell']['call_ms']:.4f} ms against "
          f"its bound {k5['one_cell']['bound_ms']:.4f} ms ({k5['one_cell']['bound_by']})",
          flush=True)
    del vpa_capture, worlds
    try:
        import cryptography  # noqa: F401

        crypto = f"importable ({cryptography.__version__})"
    except ImportError:
        crypto = None
    print(f"# vpa 4t: cryptography {crypto or 'not importable'}", flush=True)
    hooks = {"http": vpa_probe.admission_check(vpa_card["runner"], https=False)}
    if crypto:
        hooks["https"] = vpa_probe.admission_check(vpa_card["runner"], https=True)
    else:
        print("# vpa 4t: the webhook's HTTPS (vpa/certs.py) runs on the CPU only: "
              "tests/test_torch_vpa_suites.py", flush=True)
    print(f"# vpa 4t: admission webhook {hooks}", flush=True)
    check(all(h["equal"] and h["patched"] == h["reviews"] > 0 for h in hooks.values()),
          f"vpa 4t: admission webhook {hooks}")
    del vpa_card, vpa_world, cpu_view, card_view
    phase("4t the VPA recommender on the card and the CPU", t0)

    # 4u: the static checker and its sanitizer (tools/analysis_probe). (a)
    # graftlint over the port's tree with no baseline, from the worker begun
    # at 3w; (b) the fault-ladder scenario through the loadgen CLI on the
    # card: run --sanitize --trace, replay --sanitize, a plain replay; its
    # launches are a path's, counted from 0; (c) the kernel contracts'
    # ground truth
    t0 = time.perf_counter()
    lint = cpu_jobs.pop("lint 4u").get(CPU_WAIT_S)
    print(f"# lint 4u: {lint['files']} files, {len(lint['findings'])} findings with no "
          f"baseline, suppressed by rule {lint['suppressed']}; {lint['seconds']:.3f} s host "
          f"clock in a CPU worker", flush=True)
    check(lint["files"] > 200 and not lint["findings"], f"lint 4u: {lint['findings'][:20]}")
    for d in counters:
        for k in d:
            d[k] = 0
    replay = analysis_probe.ladder_replay(analysis_probe.fault_ladder_doc(), dev,
                                          workdir=os.path.join(root, "build"))
    counts = drill_probe.launch_counts()
    for name in launches:
        launches[name] += counts[name]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"# sanitized replay 4u: exit codes {replay['rc']} (sanitized run, sanitized "
          f"replay, replay), {len(replay['events'])} events, report and log equal to the run's "
          f"{replay['equal']}, ticks with errors {replay['ticks_with_errors']}; sanitized run "
          f"{replay['run_s']:.3f} s, sanitized replay {replay['sanitized_s']:.3f} s, replay "
          f"{replay['replay_s']:.3f} s, the sanitizer's cost {replay['sanitizer_s']:.3f} s "
          f"host clock; launches {counts}", flush=True)
    bad = analysis_probe.replay_problems(replay)
    check(not bad and counts["ffd_scan_swar"] > 0,
          f"sanitized replay 4u: {bad}, K2 launches {counts['ffd_scan_swar']}")
    t_truth = time.perf_counter()
    rows = analysis_probe.ground_truth(analysis_probe.contract_worlds(), dev)
    t_truth = time.perf_counter() - t_truth
    by_entry = {}
    for r in rows:
        e = by_entry.setdefault(r["entry"], {"accepted": 0, "refused": 0, "bit_equal": 0,
                                             "launched": set()})
        e["accepted" if r["accepted"] else "refused"] += 1
        e["bit_equal"] += int(r.get("bit_equal", False))
        e["launched"].update(r["launched"])
    for entry, e in by_entry.items():
        print(f"# contracts 4u: {entry}: {e['accepted']} worlds accepted and launched "
              f"{sorted(e['launched'])}, {e['bit_equal']} bit-equal to the plain version, "
              f"{e['refused']} refused, each as its contract's verdict", flush=True)
    bad = analysis_probe.truth_problems(rows)
    check(not bad, f"contracts 4u: {bad}")
    for entry, e in by_entry.items():
        check(e["bit_equal"] == e["accepted"] > 0
              and set(analysis_probe.KERNEL_OF[entry]) & e["launched"],
              f"contracts 4u: {entry}: {e}")
    print(f"# contracts 4u: {len(rows)} worlds in {t_truth:.3f} s host clock", flush=True)
    phase("4u the static checker, the sanitized replay and the kernel contracts", t0)

    # 5a: what 3o's ticks left in the perf observatory (one record a tick,
    # /perfz's body) and the ladder's proof: since the process started, no
    # rung attempt of a card estimator faulted and no breaker changed state
    # (each path was checked for its routes, forced dispatches and
    # estimator warnings as it ran)
    t0 = time.perf_counter()
    for line in ladder_probe.perf_lines(loop_sa):
        print(line.replace("# perf record", "# perf record 5a"), flush=True)
    attempts = card_metrics.estimator_kernel_rung_attempts_total.values
    faults = sum(n for key, n in attempts.items() if dict(key)["outcome"] == "fault")
    transitions = sum(card_metrics.estimator_breaker_transitions_total.values.values())
    check(faults == 0 and transitions == 0,
          f"ladder: {faults} fault attempts and {transitions} breaker transitions before 5b")
    served = {f"{dict(key)['route']}:{dict(key)['reason']}": int(n)
              for key, n in card_metrics.estimator_kernel_route_total.values.items()}
    print(f"# ladder 5a: the card's estimators served {served}; 0 fault attempts, "
          f"0 breaker transitions; every card path checked for its routes, forced "
          f"dispatches and estimator warnings", flush=True)
    phase("5a perf records and the ladder's proof", t0)

    # 5b: the fault walk on the card at 4l's size (tools/ladder_probe):
    # faults armed three times on the cuda rung of a reconcile loop's
    # estimator; each faulted estimate raises (on the card the kernels have
    # no fallback), is counted and logged, and the third opens the breaker;
    # /health-check reads degraded and the estimate past the open breaker
    # raises too; past the cooldown one half-open probe launches the kernel,
    # serves the first decisions and closes the breaker
    t0 = time.perf_counter()
    watch.reset()
    walk = ladder_probe.fault_walk(*tenth, None)
    print(ladder_probe.walk_line(walk).replace("# fault walk", "# fault walk 5b"), flush=True)
    bad = ladder_probe.walk_problems(walk)
    check(walk["card"] and not bad, f"fault walk 5b: {bad}")
    check(sum("kernel rung failed" in w for w in watch.warnings) == ladder_probe.FAULTS,
          f"fault walk 5b: the faults were not logged: {watch.warnings}")
    phase("5b the ladder's fault walk on the card", t0)

    # 5c: the native and Python rungs against the cuda rung on 4l's burst
    # (tools/ladder_probe): the native library built from its source at
    # first use (timed), every group on the native rung, every 50th on the
    # Python oracle, each served by an estimator on the CPU with the rungs
    # above it faulted
    t0 = time.perf_counter()
    rungs = ladder_probe.host_rungs(tenth[2], tenth[3], walk["steps"][0][0])
    print(ladder_probe.host_line(rungs).replace("# host rungs", "# host rungs 5c"), flush=True)
    check(rungs["built"], f"native rung: {rungs['error']}")
    check(rungs["native"][2] and rungs["python_ref"][2],
          "host rungs 5c: a host rung decided differently from the cuda rung")
    check(rungs["native"][3] == {("native", "kernel_fault"): 1}
          and rungs["python_ref"][3] == {("python_ref", "kernel_fault"): 1},
          f"host rungs 5c: the host rungs did not serve: {rungs['native'][3]} "
          f"{rungs['python_ref'][3]}")
    del tenth, walk
    phase("5c the native and Python rungs against the cuda rung", t0)

    # 5d: the fleet's fault walk on the card: faults injected on the
    # coalescer's cuda rung for two batches fail their tickets with the
    # error (no oracle rung serves) and open the breaker; a batch while it
    # is open fails too; past the cooldown on the coalescer's injected
    # clock one half-open probe serves and closes it
    t0 = time.perf_counter()
    fleet_walk = fleet_probe.fault_walk(dev)
    bad = fleet_probe.walk_problems(fleet_walk)
    print(f"# fleet fault walk 5d: {fleet_walk['steps']}; oracle batches "
          f"{fleet_walk['oracle_batches']}, failed tickets {fleet_walk['failed_tickets']}",
          flush=True)
    check(fleet_walk["card"] and not bad, f"fleet fault walk 5d: {bad}")
    watch.close()
    phase("5d the fleet's fault walk on the card", t0)

    # 5e: a kernel_fault on the cuda rung, then clear_faults, on 4r's node
    # group (tools/drill_probe.fault_doc): each faulted tick's run_once
    # raises and the driver records the typed error; no estimate serves
    # below the cuda rung; after the clear a half-open probe closes the
    # breaker and the decisions flow again
    t0 = time.perf_counter()
    faulted, _ = drill_probe.run_drill(drill_probe.fault_doc(), dev)
    for rec in faulted.records:
        print(f"# fault drill 5e: tick {rec.tick}: scale-ups {rec.scale_ups}, degraded "
              f"{rec.degraded}, errors {rec.errors}", flush=True)
    bad = drill_probe.fault_problems(faulted, card=True)
    check(not bad, f"fault drill 5e: {bad}")
    del faulted
    phase("5e the cuda rung's fault and recovery in a scenario on the card", t0)

    # 4v: the canned scenarios (tools/canned: the fourteen documents of the
    # JAX package's benchmarks/scenarios/, and gym_suite's five as plain
    # scenarios) on the card, each against its run on the CPU in a worker
    # begun after 4b. With no fault on a device rung, the decision log equal
    # byte for byte and the score report apart from its walls, with the
    # serving rung named as the CPU names it (drill_probe.comparable); the
    # four that fault one, to the design in tools/canned's docstring (the
    # ticks before the first fault as on the CPU; nothing launched and
    # nothing served, on the host rungs neither, while the card's rungs
    # are faulted, each estimate's tick recording the typed error; no host
    # rung after the clear, a half-open probe closing each card rung
    # before it serves again; the fleet's torch-rung fault never engaged).
    # Its launches are a path's, counted from 0
    t0 = time.perf_counter()
    for d in counters:
        for k in d:
            d[k] = 0
    for name, document in canned.scenario_docs():
        card = canned.run(document, dev)
        t_cpu, cpu_view = cpu_jobs.pop(f"canned 4v {name}").get(CPU_WAIT_S)
        print(f"# canned 4v: {json.dumps(canned.line(name, card, t_cpu), sort_keys=True)}",
              flush=True)
        if name in canned.DEVICE_FAULTS and "ticks" in card:
            print(f"# canned 4v: {name} by tick "
                  f"{canned.tick_summary(card['ticks'])}", flush=True)
        bad = canned.card_problems(name, document, card, cpu_view)
        check(not bad, f"canned 4v: {name}: {bad}")
        del card, cpu_view
    counts = drill_probe.launch_counts()
    for name in launches:
        launches[name] += counts[name]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"# canned 4v: {len(canned.scenario_docs())} scenarios; launches {counts}",
          flush=True)
    phase("4v the canned scenarios on the card and the CPU", t0)

    # where the burst estimate's time goes: the host operand build (mask
    # engine, packing) and the scan call on the card
    names = sorted(templates)
    t0 = time.perf_counter()
    arrays = _build_group_arrays(burst, names, templates, pad=bucket_size(len(burst)))
    t_build = time.perf_counter() - t0
    burst_caps = np.full(len(names), estimator.limiter.node_cap(0), np.int32)
    burst_ops = ffd_scan.operands_from_numpy(*arrays, burst_caps, dev)
    burst_scan_ms = event_ms(lambda: ffd_scan.ffd_binpack_groups_cuda(
        *burst_ops[:3], bucket_size(int(burst_caps.max())), burst_ops[3]
    ))
    print(
        f"# burst estimate {t_burst:.3f} s: host operand build {t_build:.3f} s, "
        f"scan call {burst_scan_ms:.3f} ms on the card; headline {t_headline:.3f} s, "
        f"replicated {t_replicated:.3f} s, affinity workload {t_aff:.3f} s, "
        f"replicated affinity {t_replicated_aff:.3f} s, fit-K4 {t_fit:.3f} s", flush=True,
    )
    # where the ticks' time goes (tools/tick_probe.split_line): the host
    # clock of each part; the greedy loop's span on the card, its launches
    # and device time a step (torch.profiler), the card-busy time and the
    # idle share derived from them; the estimate's kernel on its operands
    seq_ticks = {f"sequence {k + 1}": rec for k, (*_, rec) in enumerate(seq)}
    for label, rec in {**tick_card, **seq_ticks}.items():
        _, kernel_fn, kernel_args = rec["kernel"]
        print(tick_probe.split_line(label, rec, tick_probe.profile_tick(rec),
                                    event_ms(lambda: kernel_fn(*kernel_args))), flush=True)
    # where the scale-down loops' time goes (tools/scaledown_probe.split_line)
    for label, rec in down_card.items():
        prof = scaledown_probe.dispatch_profile(rec["loops"][-1]["dispatch_ops"])
        print(scaledown_probe.split_line(label, rec, prof), flush=True)
    print(f"# total {time.perf_counter() - t_start:.1f} s", flush=True)
    import resource   # ru_maxrss is in KiB on Linux

    print(f"# peak resident memory: this process "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB, the largest "
          f"child that has ended {resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20:.2f}"
          f" GiB", flush=True)
    print(smi_line, flush=True)       # again: the head of a long log may be cut

    print(json.dumps({"kernels": kernels, "torch_preempt": preempt_line}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        if _POOL is not None:
            _POOL.terminate()
            _POOL.join()
    sys.exit(code)
