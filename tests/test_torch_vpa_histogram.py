"""The VPA's histogram bank (``autoscaler_tpu_torch/vpa/histogram.py``) and
its ordered scatter-add (``ops/histogram.py``, K5's plain version) on the
CPU against the JAX package's bank, bit for bit (tolerance 0): the same
seeded numpy inputs into both packages.

- the blocked scan against ``jnp.cumsum`` on a [4096, 176] bank of mixed
  magnitudes, on the axis lengths around XLA:CPU's block of 16, and on
  subnormal weights (XLA:CPU flushes them);
- ``percentile`` at 0.5, 0.9 and 0.95 on banks where every bucket is
  nonzero;
- ``add_samples`` with 10^5 samples in heavily duplicated (series,
  bucket) cells at real epochs (T0 = 1.7e9: the re-reference branch),
  then later batches (one more than ten half-lives on);
- ``grow_to``, ``checkpoint`` and ``restore`` onto banks with older and
  newer decay references;
- the plain ordered add against a Python loop;
- no ``torch.cumsum`` and no ``index_add_`` on a card's tensor on the VPA
  path, and K5's launch path without a CUDA compiler raises.
"""
import ast
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autoscaler_tpu.vpa.histogram as jh
import autoscaler_tpu_torch.vpa.histogram as th
from autoscaler_tpu_torch.ops import histogram as ops_histogram
from torch_parity import assert_bits_equal

REPO = Path(__file__).resolve().parent.parent
T0 = 1.7e9
DAY = 86400.0
SPECS = {"cpu": (jh.CPU_SPEC, th.CPU_SPEC), "memory": (jh.MEMORY_SPEC, th.MEMORY_SPEC)}


def mixed(rng, C, B, negative=0.05, zero=0.1):
    """[C, B] f32 of magnitudes 1e-6..1e6, some negative, zero and -0.0."""
    w = (rng.random((C, B)) * 10.0 ** rng.uniform(-6, 6, (C, B))).astype(np.float32)
    w[rng.random((C, B)) < negative] *= -1
    w[rng.random((C, B)) < zero] = 0.0
    w[rng.random((C, B)) < zero / 2] = -0.0
    return w


def twin_banks(C, resource="cpu", half_life_s=DAY):
    jspec, tspec = SPECS[resource]
    return (jh.HistogramBank(C, jspec, half_life_s),
            th.HistogramBank(C, tspec, half_life_s, device="cpu"))


def assert_banks_equal(jbank, tbank):
    assert_bits_equal(np.asarray(jbank.weights), tbank.weights)
    assert_bits_equal(np.asarray(jbank.total), tbank.total)
    assert jbank.ref_ts == tbank.ref_ts


def samples(rng, K, C, resource="cpu", t_end=T0, span=8 * DAY):
    """K samples over C series with heavy duplicates: most land in a few
    series, and each series' values sit in a few buckets."""
    hot = rng.random(K) < 0.7
    series = np.where(hot, rng.integers(0, max(1, C // 8), K), rng.integers(0, C, K))
    base = rng.choice([0.1, 0.25, 0.5, 2.0], K) if resource == "cpu" else \
        rng.choice([2e8, 5e8, 1e9, 4e9], K)
    values = base * np.exp(rng.normal(0.0, 0.05, K))
    weights = np.maximum(values, 0.025) if resource == "cpu" else np.ones(K)
    ts = t_end - rng.uniform(0.0, span, K)
    ts[rng.integers(0, K)] = t_end
    return series.astype(np.int64), values, weights, ts


# -- the scan -----------------------------------------------------------------------


def test_blocked_scan_matches_jnp_cumsum_on_a_full_bank():
    w = mixed(np.random.default_rng(0), 4096, 176)
    assert_bits_equal(np.asarray(jnp.cumsum(jnp.asarray(w), axis=1)),
                      th.xla_cumsum(torch.from_numpy(w)))


@pytest.mark.parametrize("B", [1, 2, 15, 16, 17, 33, 176, 257, 1000])
def test_blocked_scan_matches_jnp_cumsum_on_every_axis_length(B):
    rng = np.random.default_rng(B)
    w = mixed(rng, 7, B, zero=0.3)
    w[0] = -0.0          # an all -0.0 row: the scan's +0.0 starts show
    w[1, 0] = -0.0
    assert_bits_equal(np.asarray(jnp.cumsum(jnp.asarray(w), axis=1)),
                      th.xla_cumsum(torch.from_numpy(w)))


def test_blocked_scan_flushes_subnormals_as_xla_does():
    w = np.full((6, 176), 1e-41, np.float32)
    w[:, ::3] = 3e-39
    w[1] = 1.2e-38
    w[2, ::2] = -1.18e-38
    w[3, ::5] = 1.0
    ref = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    assert (ref == 0).any()   # XLA:CPU flushed them
    assert_bits_equal(ref, th.xla_cumsum(torch.from_numpy(w)))


# -- percentile -----------------------------------------------------------------


@pytest.mark.parametrize("resource", ["cpu", "memory"])
def test_percentile_matches_on_banks_with_every_bucket_nonzero(resource):
    rng = np.random.default_rng(3)
    C = 512
    weights = (rng.uniform(1e-3, 1.0, (C, 176)) * 10.0 ** rng.integers(-2, 4, (C, 1))
               ).astype(np.float32)
    total = weights.astype(np.float64).sum(axis=1).astype(np.float32)
    # totals at the scan's own sum (the `cum >= p * total - 1e-9` edge), a
    # little off it, zero and negative
    total[::4] = np.asarray(jnp.cumsum(jnp.asarray(weights), axis=1))[::4, -1]
    total[1::4] *= np.float32(1.0 + 1e-6)
    total[7] = 0.0
    total[11] = -1.0
    jspec, tspec = SPECS[resource]
    jbank = jh.HistogramBank(C, jspec)
    jbank.weights, jbank.total = jnp.asarray(weights), jnp.asarray(total)
    tbank = th.bank_from_arrays(weights, total, 0.0, tspec, device="cpu")
    for p in (0.5, 0.9, 0.95):
        assert_bits_equal(np.asarray(jbank.percentile(p)), tbank.percentile(p))


def test_percentile_reads_subnormal_weights_and_totals_as_zero():
    C = 8
    weights = np.zeros((C, 176), np.float32)
    weights[:, 40] = 1e-39
    weights[:4, 90] = 2.0
    total = np.full(C, 2.0, np.float32)
    total[4:] = 1e-40
    jbank = jh.HistogramBank(C, jh.CPU_SPEC)
    jbank.weights, jbank.total = jnp.asarray(weights), jnp.asarray(total)
    tbank = th.bank_from_arrays(weights, total, 0.0, th.CPU_SPEC, device="cpu")
    for p in (0.5, 0.9):
        assert_bits_equal(np.asarray(jbank.percentile(p)), tbank.percentile(p))


# -- sample ingestion -----------------------------------------------------------


@pytest.mark.parametrize("resource", ["cpu", "memory"])
def test_add_samples_matches_at_real_epochs(resource):
    rng = np.random.default_rng(5 if resource == "cpu" else 6)
    C = 64
    jbank, tbank = twin_banks(C, resource)
    batch = samples(rng, 120_000, C, resource)
    for bank in (jbank, tbank):
        bank.add_samples(*batch)
    assert tbank.ref_ts == T0     # the re-reference branch ran
    assert_banks_equal(jbank, tbank)
    # a later live batch, a peak replaced (negative weight), then one more
    # than ten half-lives on (a second re-reference)
    for t_end, negate in ((T0 + 3600.0, True), (T0 + 12 * DAY, False)):
        series, values, weights, ts = samples(rng, 20_000, C, resource, t_end, span=3600.0)
        if negate:
            weights = np.where(rng.random(weights.shape) < 0.2, -1.0, weights)
        for bank in (jbank, tbank):
            bank.add_samples(series, values, weights, ts)
        assert_banks_equal(jbank, tbank)
    for p in (0.5, 0.9, 0.95):
        assert_bits_equal(np.asarray(jbank.percentile(p)), tbank.percentile(p))


def test_add_samples_cells_are_heavily_duplicated():
    series, values, _, _ = samples(np.random.default_rng(5), 120_000, 64)
    cells = series * 176 + th.CPU_SPEC.bucket_of(values)
    _, counts = np.unique(cells, return_counts=True)
    assert counts.max() > 1000 and (counts > 100).sum() > 20


def test_add_samples_flushes_what_xla_flushes():
    """Weights decayed into f32's subnormal range are read as zero, and a
    re-reference whose factor is subnormal zeroes the bank."""
    jbank, tbank = twin_banks(4)
    K = 400
    rng = np.random.default_rng(8)
    series = rng.integers(0, 4, K)
    values = rng.uniform(0.1, 1.0, K)
    ts = T0 - rng.uniform(0, 130 * DAY, K)   # weights down to 2^-130
    ts[0] = T0
    for bank in (jbank, tbank):
        bank.add_samples(series, values, np.ones(K), ts)
        # 130 half-lives on: a subnormal f32 factor
        bank.add_samples(series[:10], values[:10], np.ones(10), np.full(10, T0 + 130 * DAY))
    assert_banks_equal(jbank, tbank)
    # a checkpoint restored at a subnormal scale, then samples into its
    # cells: XLA reads the restored cells as zero
    tiny = {"total_weight": 3e-39, "bucket_weights": {5: 10000, 6: 3000, 40: 1},
            "ref_ts": T0 + 130 * DAY}
    for bank in (jbank, tbank):
        bank.restore(1, tiny)
        bank.add_samples(np.ones(3, np.int64), np.full(3, 0.0125), np.full(3, 1e-38),
                         np.full(3, T0 + 130 * DAY))
    assert_banks_equal(jbank, tbank)
    assert_bits_equal(np.asarray(jbank.percentile(0.5)), tbank.percentile(0.5))


def test_grow_checkpoint_and_restore_match():
    rng = np.random.default_rng(9)
    jbank, tbank = twin_banks(4)
    batch = samples(rng, 5000, 4)
    for bank in (jbank, tbank):
        bank.add_samples(*batch)
        bank.grow_to(9)
        bank.grow_to(5)           # never shrinks
    assert_banks_equal(jbank, tbank)
    assert tbank.num_series == 9
    ckpts = [jbank.checkpoint(s) for s in range(9)]
    assert ckpts == [tbank.checkpoint(s) for s in range(9)]
    assert ckpts[0]["total_weight"] > 0 and ckpts[8]["bucket_weights"] == {}
    # onto fresh banks (the checkpoint's reference adopted), a bank with an
    # older reference (its mass re-based), and one with a newer reference
    # (the checkpoint re-based)
    for ref in (None, T0 - 30 * DAY, T0 + 2 * DAY):
        jb, tb = twin_banks(9)
        if ref is not None:
            early = samples(rng, 3000, 9, t_end=ref, span=DAY)
            jb.add_samples(*early)
            tb.add_samples(*early)
        for s, ckpt in enumerate(ckpts):
            jb.restore(s, ckpt)
            tb.restore(s, ckpt)
        assert_banks_equal(jb, tb)
        for p in (0.5, 0.95):
            assert_bits_equal(np.asarray(jb.percentile(p)), tb.percentile(p))


def test_bank_from_arrays_carries_a_jax_bank_over():
    rng = np.random.default_rng(10)
    jbank, _ = twin_banks(16)
    jbank.add_samples(*samples(rng, 8000, 16))
    tbank = th.bank_from_arrays(np.asarray(jbank.weights), np.asarray(jbank.total),
                                jbank.ref_ts, th.CPU_SPEC, device="cpu")
    assert_banks_equal(jbank, tbank)
    more = samples(rng, 8000, 16, t_end=T0 + 600.0, span=600.0)
    jbank.add_samples(*more)
    tbank.add_samples(*more)
    assert_banks_equal(jbank, tbank)
    with pytest.raises(ValueError):
        th.bank_from_arrays(np.zeros((2, 10)), np.zeros(2), 0.0, th.CPU_SPEC, device="cpu")


# -- the ordered add's plain version ----------------------------------------------


def test_plain_ordered_add_is_the_serial_loop():
    rng = np.random.default_rng(11)
    N, K = 50, 200_000
    target = mixed(rng, 1, N, negative=0.3, zero=0.0)[0]
    index = rng.integers(0, N, K).astype(np.int32)
    values = mixed(rng, 1, K, negative=0.4)[0]
    want = target.copy()
    for i, v in zip(index.tolist(), values.tolist()):
        want[i] = np.float32(want[i] + np.float32(v))
    got = ops_histogram.ordered_scatter_add(
        torch.from_numpy(target.copy()), torch.from_numpy(index), torch.from_numpy(values))
    assert_bits_equal(want, got)
    # index_put_ with accumulate adds in another order: the order matters
    other = torch.from_numpy(target.copy()).index_put_(
        (torch.from_numpy(index).long(),), torch.from_numpy(values), accumulate=True)
    assert not torch.equal(other, got)


def test_plain_ordered_add_drops_indices_out_of_range():
    target = torch.zeros(4)
    out = ops_histogram.ordered_scatter_add(
        target, torch.tensor([0, 4, -1, 3, 0], dtype=torch.int64),
        torch.tensor([1.0, 5.0, 7.0, 2.0, 0.5]))
    assert out is target and target.tolist() == [1.5, 0.0, 0.0, 2.0]
    assert ops_histogram.LAUNCHES["ordered_scatter_add"] == 0   # no launch on the CPU


def test_ordered_add_checks_its_operands():
    with pytest.raises(ValueError):
        ops_histogram.ordered_scatter_add(torch.zeros(4, dtype=torch.float64),
                                          torch.zeros(1, dtype=torch.int32), torch.zeros(1))
    with pytest.raises(ValueError):
        ops_histogram.ordered_scatter_add(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                                          torch.zeros(1))
    with pytest.raises(ValueError):
        ops_histogram.ordered_scatter_add(torch.zeros((2, 2)), torch.zeros(1, dtype=torch.int32),
                                          torch.zeros(1))


def test_ordered_add_kernel_builds_or_raises(monkeypatch, tmp_path):
    """K5's launch path has no fallback: with no CUDA compiler the build
    raises (the wrapper takes the plain version only for CPU tensors)."""
    import torch.utils.cpp_extension as cpp_ext

    from autoscaler_tpu_torch.ops import _build

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("histogram")


def _calls(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in ("cumsum", "index_add_",
                                                             "index_add", "cumulative_sum"):
            yield node.attr, node.lineno, tree


def test_no_cumsum_or_unordered_add_on_the_vpa_path():
    """The VPA's modules call neither ``cumsum`` nor ``index_add_``; in
    ops/histogram.py ``index_add_`` is called by the plain version alone,
    which the wrapper runs only for CPU tensors."""
    for path in sorted((REPO / "autoscaler_tpu_torch" / "vpa").glob("*.py")):
        assert not list(_calls(path)), path
    ops = REPO / "autoscaler_tpu_torch" / "ops" / "histogram.py"
    found = list(_calls(ops))
    assert [name for name, _, _ in found] == ["index_add_"]
    (_, line, tree), = found
    plain = next(f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                 and f.name == "_ordered_scatter_add_plain")
    assert plain.lineno <= line <= plain.end_lineno
