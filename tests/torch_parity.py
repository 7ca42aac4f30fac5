"""Shared helpers of the tests/test_torch_*.py parity tests: seeded numpy
worlds fed to both the JAX package and its PyTorch port, and a bit-exact
comparison (tolerance 0: every operation on both sides is an IEEE f32
mul, add, sub or compare in a fixed order, or integer arithmetic)."""
import numpy as np
import torch

CPU, MEMORY, GPU, PODS = 0, 1, 3, 5


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bits_equal(ref, out) -> None:
    """Equal shapes, dtypes' kinds and bit patterns (so -0.0 != +0.0 and
    NaN payloads count)."""
    a, b = to_np(ref), to_np(out)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype == np.float32, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def assert_results_equal(ref, out) -> None:
    assert len(ref) == len(out)
    for name, a, b in zip(ref._fields, ref, out):
        try:
            assert_bits_equal(a, b)
        except AssertionError as e:
            raise AssertionError(f"field {name}: {e}") from None


def rand_case(seed, P=200, G=5, R=6, fractional=False):
    """The world of tests/test_pallas_binpack.py::rand_case; fractional=True
    gives decimal memory (bytes in 10^6 units, stored in MiB)."""
    rng = np.random.default_rng(seed)
    req = np.zeros((P, R), np.float32)
    req[:, CPU] = rng.integers(50, 2000, P)
    req[:, MEMORY] = rng.integers(64, 4096, P)
    if fractional:
        req[:, MEMORY] = req[:, MEMORY] * np.float32(1e6 / 2**20)
    req[:, PODS] = 1.0
    masks = rng.random((G, P)) > 0.1
    allocs = np.zeros((G, R), np.float32)
    allocs[:, CPU] = rng.integers(2000, 16000, G)
    allocs[:, MEMORY] = rng.integers(4096, 32768, G)
    allocs[:, PODS] = 32.0
    return req, masks, allocs
