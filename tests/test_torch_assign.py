"""The on-device matchers against psalm_tpu's on the CPU: the plain versions
of K6 (``train/lap.py``) and K7 (``train/auction.py``) against JAX's
``lap_assign`` and ``auction_assign`` under ``jax.jit``, the criterion under
each ``set_assign_impl`` matcher on both sides, and the wrappers' dispatch
(the plain version for a CPU tensor, the kernel or an error for any other).
The kernels against their plain versions on a card are in
tests/test_torch_package.py (marked ``gpu``: that file imports no JAX).
The kernels' warp reductions on ordered-int keys (K6's argmin, K7's best,
second best and winning bid) are emulated here in numpy and held against
the plain versions' choices on inputs full of ties, with two broken keys
that must pick otherwise; these run no JAX.

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


# -- the kernels' keyed reductions, emulated in numpy ------------------------
# K6 (csrc/lap.cu) and K7 (csrc/auction.cu) reduce over a warp by redux.sync
# on ordered-int keys: K6's argmin is the least key, then the lowest column
# among the lanes that hold it; K7's best and second best the same on a max;
# K7's winner of an object the largest 64-bit key (bid's order << 32 |
# N - 1 - p). The emulations below follow the kernels lane by lane and are
# held against the choices the plain versions make with torch's argmin,
# argmax, amax and scatter_reduce. Each mutant is a kernel's key with one
# part dropped: "no_plus_zero" keys x in place of x + 0.0f (-0.0 then keys
# below +0.0, though the two compare equal), "no_inverted_id" packs p in
# place of N - 1 - p (equal bids then go to the higher id). Each must pick
# otherwise than the plain version on some of these inputs.

I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min
F32_NEG = np.float32(auction.NEG)


def _key(x, mutant=None):
    """csrc's key_of: x + 0.0f (a scalar f32), its bits ordered as the
    floats order."""
    x = np.float32(x)
    if mutant != "no_plus_zero":
        x = np.float32(x + np.float32(0.0))
    i = int(np.array(x).view(np.int32))
    return i if i >= 0 else i ^ 0x7fffffff


def _unkey(k):
    """The float of a key (an int32, or its 32 bits unsigned)."""
    k = k - (1 << 32) if k >= 1 << 31 else k
    return float(np.array(k if k >= 0 else k ^ 0x7fffffff,
                          np.int32).view(np.float32))


def emulate_k6_argmin(spc, scanned, mutant=None):
    """A K6 pop's column: lane l scans its columns l, l + 32, ... in order,
    a scanned one read as INF, its first column seeding its minimum and a
    later one taking it only if less (float compares); then the least key
    of the lanes' minima, then the lowest column among the lanes that hold
    it (a lane without columns offers a key above every float's)."""
    Q = len(spc)
    best = [I32_MAX] * 32
    idx = [I32_MAX] * 32
    for lane in range(32):
        low = None
        for j in range(lane, Q, 32):
            val = np.float32(np.inf if scanned[j] else spc[j])
            if low is None or val < low:
                low, idx[lane] = val, j
        if low is not None:
            best[lane] = _key(low, mutant)
    top = min(best)
    return min(i for b, i in zip(best, idx) if b == top)


def emulate_k7_best(net, mutant=None):
    """A K7 bidder's (best_j, best, second): each lane's first maximum and
    its second best by float compares, then the greatest key, the lowest
    object that holds it, and the greatest key of the rest (the lane of
    best_j offers its second best), second at least NEG."""
    Q = len(net)
    b1, s1, i1 = [-np.inf] * 32, [-np.inf] * 32, [I32_MAX] * 32
    for lane in range(32):
        for j in range(lane, Q, 32):
            n = np.float32(net[j])
            if n > b1[lane]:
                s1[lane], b1[lane], i1[lane] = b1[lane], n, j
            elif n > s1[lane]:
                s1[lane] = n
    keys = [_key(b, mutant) for b in b1]
    top = max(keys)
    best_j = min(i for k, i in zip(keys, i1) if k == top)
    rest = max(_key(s if i == best_j else b, mutant)
               for b, s, i in zip(b1, s1, i1))
    return best_j, _unkey(top), max(_unkey(rest), float(F32_NEG))


def emulate_k7_winners(bid, best_j, unassigned, Q, mutant=None):
    """Each object's (winner, price) from one 64-bit atomic max a bid above
    NEG: winner N and no price where no bid arrived."""
    N = len(bid)
    top = [0] * Q
    for p in range(N):
        if unassigned[p] and np.float32(bid[p]) > F32_NEG:
            hi = (_key(bid[p], mutant) ^ 0x80000000) & 0xffffffff
            lo = p if mutant == "no_inverted_id" else N - 1 - p
            top[best_j[p]] = max(top[best_j[p]], hi << 32 | lo)
    winner = [N if k == 0 else (k & 0xffffffff if mutant == "no_inverted_id"
                                else N - 1 - (k & 0xffffffff)) for k in top]
    price = [None if k == 0 else _unkey((k >> 32) ^ 0x80000000) for k in top]
    return winner, price


def _k6_argmin_case(rng):
    Q = int(rng.choice([7, 16, 40, 100]))
    spc = rng.choice(np.asarray([-1.0, -0.0, 0.0, 0.0, 2.0, np.inf],
                                np.float32), Q)
    scanned = rng.random(Q) < 0.3
    got = lambda mutant: emulate_k6_argmin(spc, scanned, mutant)
    want = int(torch.where(torch.from_numpy(scanned), lap.INF,
                           torch.from_numpy(spc)).argmin())
    return got, want


def _k7_best_case(rng):
    Q = int(rng.choice([1, 7, 16, 40, 100]))
    top = [1.5, 1.5] if rng.random() < 0.5 else []  # else +-0.0 is the best
    net = rng.choice(np.asarray([-3.0, -0.0, 0.0, -2e9] + top, np.float32), Q)
    t = torch.from_numpy(net)[None]
    j = t.argmax(1)
    want = (int(j), float(t.amax(1)),
            float(t.scatter(1, j[:, None], auction.NEG).amax(1)))
    return lambda mutant: emulate_k7_best(net, mutant), want


def _k7_winner_case(rng):
    N, Q = int(rng.choice([3, 16, 100])), int(rng.choice([4, 100]))
    bid = rng.choice(np.asarray([-2e9, auction.NEG, -0.0, 0.0, 0.5, 0.5, 2.0],
                                np.float32), N)
    best_j = rng.integers(0, min(Q, 4), N)
    unassigned = rng.random(N) < 0.7
    # auction_assign_plain's round, on one image
    ids = torch.arange(N)
    un, bj = torch.from_numpy(unassigned), torch.from_numpy(best_j)
    bid_masked = torch.where(un, torch.from_numpy(bid), auction.NEG)
    obj_bid = torch.full((Q,), auction.NEG).scatter_reduce(0, bj, bid_masked,
                                                           "amax")
    has_bid = obj_bid > auction.NEG
    is_winner = un & (bid_masked >= obj_bid[bj]) & has_bid[bj]
    winner = torch.full((Q,), N).scatter_reduce(
        0, bj, torch.where(is_winner, ids, N), "amin")
    want = (winner.tolist(), [float(obj_bid[j]) if w < N else None
                              for j, w in enumerate(winner.tolist())])
    return (lambda mutant: emulate_k7_winners(bid, best_j, unassigned, Q,
                                              mutant)), want


KEYED = {"k6_argmin": _k6_argmin_case, "k7_best_second": _k7_best_case,
         "k7_winner": _k7_winner_case}


@pytest.mark.parametrize("reduction, mutant", [
    ("k6_argmin", None), ("k6_argmin", "no_plus_zero"),
    ("k7_best_second", None), ("k7_best_second", "no_plus_zero"),
    ("k7_winner", None), ("k7_winner", "no_inverted_id"),
    ("k7_winner", "no_plus_zero")])
def test_kernel_keyed_reductions_pick_as_the_plain_versions(reduction, mutant):
    """On 300 seeded inputs full of ties (equal values in different lanes,
    +-0.0, INF, bids at and below NEG) each kernel's keyed reduction picks
    what the plain version picks; each mutant picks otherwise on some."""
    rng = np.random.default_rng(16)
    differ = 0
    for _ in range(300):
        got, want = KEYED[reduction](rng)
        differ += got(mutant) != want
    if mutant is None:
        assert differ == 0
    else:
        assert differ > 0, f"the mutant {mutant} picked as the plain version"
