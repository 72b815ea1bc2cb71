"""The on-device matchers against psalm_tpu's on the CPU: the plain versions
of K6 (``train/lap.py``) and K7 (``train/auction.py``) against JAX's
``lap_assign`` and ``auction_assign`` under ``jax.jit``, the criterion under
each ``set_assign_impl`` matcher on both sides, and the wrappers' dispatch
(the plain version for a CPU tensor, the kernel or an error for any other).
The kernels against their plain versions on a card are in
tests/test_torch_package.py (marked ``gpu``: that file imports no JAX).

Tolerances: assignments equal, integer for integer (random costs, whose
optimum is unique, and for the auction its own rounds: the same f32 bids in
the same order); the exact solver's total cost equal to scipy's optimum
(float64) to rtol 1e-6; the criterion's losses within 1e-4 relative (the
matchers' assignments are equal, the losses then agree to 1e-5 as in
tests/test_torch_criterion.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from test_torch_criterion import P, Q, _case, _draws, _to

import psalm_tpu.train.criterion as jcriterion
from psalm_tpu.config import LossConfig as JLossConfig
from psalm_tpu.train.criterion import PSALMCriterion as JCriterion
from psalm_tpu.train.auction import auction_assign as jauction
from psalm_tpu.train.lap import lap_assign as jlap
from psalm_tpu_torch.config import LossConfig
from psalm_tpu_torch.ops import _build
from psalm_tpu_torch.train import auction, criterion, lap


def _cost(seed, B, Q, N, n_valid, scale=5.0):
    """Random costs [B, Q, N], the criterion's 1e8 in padding columns."""
    rng = np.random.default_rng(seed)
    cost = (rng.standard_normal((B, Q, N)) * scale).astype(np.float32)
    for b in range(B):
        cost[b, :, n_valid[b]:] = 1e8
    return cost, np.asarray(n_valid, np.int32)


def _square(seed):
    """test_lap.py's unique zero-cost perfect matching of 16 x 16."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1.0, 2.0, (16, 16)).astype(np.float32)
    base[rng.permutation(16), np.arange(16)] = 0.0
    return base[None], np.asarray([16], np.int32)


# test_lap.py's cases: padded batches, the full square with a unique
# optimum, no valid target, and the production shapes
LAP_CASES = {
    **{f"b3_q24_n13_seed{s}": (lambda s=s: _cost(s, 3, 24, 13, [13, 7, 1]))
       for s in range(4)},
    "square16_unique": lambda: _square(99),
    "zero_valid": lambda: (np.full((1, 5, 4), 1e8, np.float32),
                           np.asarray([0], np.int32)),
    "q100_n32_valid25": lambda: _cost(7, 1, 100, 32, [25], scale=1.0),
    "full_100x100": lambda: _cost(100, 2, 100, 100, [100, 100], scale=3.0),
}


def _optimum(cost, n):
    c = np.asarray(cost[:, :n], np.float64)
    rows, cols = linear_sum_assignment(c)
    return c[rows, cols].sum()


@pytest.mark.parametrize("case", sorted(LAP_CASES))
def test_plain_lap_matches_jax_and_scipy(case):
    cost, n_valid = LAP_CASES[case]()
    want_src, want_valid = map(np.asarray, jax.jit(jlap)(
        jnp.asarray(cost), jnp.asarray(n_valid)))
    src, valid = lap.lap_assign(torch.from_numpy(cost),
                                torch.from_numpy(n_valid))
    assert src.dtype == torch.long and valid.dtype == torch.bool
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    for b, n in enumerate(n_valid):
        picked = src[b, :n].numpy()
        assert len(set(picked.tolist())) == n
        ours = np.asarray(cost[b], np.float64)[picked, np.arange(n)].sum()
        np.testing.assert_allclose(ours, _optimum(cost[b], n), rtol=1e-6)
        assert (src[b, n:] == 0).all()


def test_plain_lap_guards_non_finite_costs_as_jax():
    cost, n_valid = _cost(5, 2, 12, 6, [6, 4])
    cost[0, 3, 1], cost[0, 5, 2], cost[1, 0, 0] = np.nan, np.inf, -np.inf
    want = np.asarray(jax.jit(jlap)(jnp.asarray(cost),
                                    jnp.asarray(n_valid))[0])
    got = lap.lap_assign(torch.from_numpy(cost), torch.from_numpy(n_valid))[0]
    np.testing.assert_array_equal(got.numpy(), want)


AUCTION_CASES = {
    # tests/test_criterion.py::test_auction_assign_near_optimal
    "b2_q50_n16": lambda: _cost(7, 2, 50, 16, [16, 5], scale=3.0),
    "b3_q24_n13": lambda: _cost(0, 3, 24, 13, [13, 7, 1]),
    "b2_q100_n100": lambda: _cost(3, 2, 100, 100, [100, 60], scale=3.0),
    # integer costs: ties among bids and among objects
    "integer_ties": lambda: (np.random.default_rng(9).integers(
        0, 4, (4, 30, 12)).astype(np.float32), np.asarray([12, 12, 5, 0],
                                                          np.int32)),
}


@pytest.mark.parametrize("case", sorted(AUCTION_CASES))
def test_plain_auction_matches_jax(case):
    cost, n_valid = AUCTION_CASES[case]()
    want_src, want_valid = map(np.asarray, jax.jit(jauction)(
        jnp.asarray(cost), jnp.asarray(n_valid)))
    steps = torch.zeros(len(n_valid), dtype=torch.int32)
    src, valid = auction.auction_assign(torch.from_numpy(cost),
                                        torch.from_numpy(n_valid), steps=steps)
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert (steps[torch.from_numpy(n_valid) > 0] > 0).all()


def test_auction_eps_rounds_as_xla_folds_it():
    """JAX's eps_scale * spread / (N + 1) runs as spread * f32(eps_scale /
    (N + 1)); the port's coefficient is that constant."""
    spread = np.random.default_rng(0).uniform(1, 1e3, 4096).astype(np.float32)
    for N in (1, 13, 16, 100):
        want = np.asarray(jax.jit(lambda s: 1e-3 * s / (N + 1))(spread))
        got = (torch.from_numpy(spread)
               * auction.eps_coefficient(1e-3, N)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def matcher():
    """Sets one matcher in both packages; scipy again afterwards."""
    def use(name):
        jcriterion.set_assign_impl(name)
        criterion.set_assign_impl(name)
    yield use
    use("scipy")


# every loss term at once: the class-name, [SEG] and region losses all read
# the matcher's assignment
ALL_TERMS = dict(compute_class=True, compute_seg=True, compute_region=True)


@pytest.mark.parametrize("impl", ["lap", "auction"])
def test_criterion_under_each_matcher_matches_jax(matcher, impl):
    """tests/test_torch_criterion.py's case and draws on both sides; JAX's
    criterion under ``jax.jit`` (its matcher's loops eagerly take
    seconds)."""
    matcher(impl)
    outputs, targets = _case(3)
    draws = _draws()
    jcrit = JCriterion(JLossConfig(train_num_points=P), Q,
                       uniform_fn=lambda key, shape: draws[tuple(shape)])
    tcrit = criterion.PSALMCriterion(
        LossConfig(train_num_points=P), Q,
        uniform_fn=lambda g, shape: torch.from_numpy(draws[tuple(shape)]))
    want = jax.jit(lambda o, t: jcrit(jax.random.PRNGKey(0), o, t,
                                      **ALL_TERMS))(
        _to(jnp.asarray, outputs), _to(jnp.asarray, targets))
    got = tcrit(torch.Generator(), _to(torch.from_numpy, outputs),
                _to(torch.from_numpy, targets), **ALL_TERMS)
    assert set(want) == set(got)
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert abs(g - w) <= 1e-4 * max(abs(w), 1e-6), (k, g, w)
    assert all(float(got[k]) > 0 for k in ("loss_SEG_class",
                                           "loss_class_name_class",
                                           "loss_region_class"))


def test_on_device_matchers_leave_scipy_alone(matcher, monkeypatch):
    """``"lap"`` and ``"auction"`` never reach the host route; the default
    is scipy's, and an unknown name is refused."""
    assert criterion._assign_impl() == "scipy"

    def host(*args):
        raise AssertionError("the host route was taken")

    cost, n_valid = _cost(1, 2, 10, 4, [4, 2])
    want = criterion.hungarian_assign(torch.from_numpy(cost),
                                      torch.from_numpy(n_valid))
    monkeypatch.setattr(criterion, "_lsa_host", host)
    for impl in ("lap", "auction"):
        matcher(impl)
        got = criterion.hungarian_assign(torch.from_numpy(cost),
                                         torch.from_numpy(n_valid))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), impl
    with pytest.raises(AssertionError):
        criterion.set_assign_impl("hungarian")


WRAPPERS = {"lap": (lap, lap.lap_assign), "auction": (auction,
                                                      auction.auction_assign)}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_tensors_take_the_plain_version_and_count_no_launch(name):
    module, fn = WRAPPERS[name]
    plain = {"lap": lap.lap_assign_plain,
             "auction": auction.auction_assign_plain}[name]
    n = module.LAUNCHES
    cost, n_valid = _cost(2, 3, 20, 8, [8, 3, 0])
    got = fn(torch.from_numpy(cost), torch.from_numpy(n_valid))
    want = plain(torch.from_numpy(cost), torch.from_numpy(n_valid))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert module.LAUNCHES == n


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_other_devices_reach_the_kernel_loader(name, monkeypatch):
    def loader():
        raise RuntimeError("kernel loader reached")

    monkeypatch.setattr(_build, "library", loader)
    cost = torch.empty(2, 10, 4, device="meta")
    with pytest.raises(RuntimeError, match="kernel loader reached"):
        WRAPPERS[name][1](cost, torch.empty(2, device="meta"))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_check_inputs_before_launch(name, monkeypatch):
    """A non-CUDA tensor is refused before any launch: no quiet plain
    route."""
    monkeypatch.setattr(_build, "library", lambda: None)
    module, fn = WRAPPERS[name]
    n = module.LAUNCHES
    with pytest.raises(ValueError, match="cost is on meta"):
        fn(torch.empty(2, 10, 4, device="meta"), torch.empty(2, device="meta"))
    assert module.LAUNCHES == n
