"""The one traffic generator: the same seed draws the same requests, and
every seed sends the same set of sizes in another order."""
import collections
import json

import numpy as np
import pytest

from perfbench import traffic
from perfbench.spec import HERE

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    spec = _mix(name)
    a = traffic.ClosedLoop(spec, 2**31 + 11, 1000)
    b = traffic.ClosedLoop(spec, 2**31 + 11, 1000)
    for c in (0, spec["clients"] - 1):
        for i in range(3):
            ra, rb = a.request(c, i), b.request(c, i)
            assert ra.max_new == rb.max_new
            assert np.array_equal(ra.prompt, rb.prompt)
            assert ra.prompt.dtype == np.int32
            assert 0 <= ra.prompt.min() and ra.prompt.max() < 1000


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_sizes_in_the_same_order(name):
    """The seed draws the ids only: a run's work does not depend on it."""
    spec = _mix(name)
    one, other = (traffic.ClosedLoop(spec, s, 1000) for s in (1, 2**31 + 99))
    for c in range(one.clients):
        for i in range(2 * spec["sizes_per_client"]):
            a, b = one.request(c, i), other.request(c, i)
            assert (len(a.prompt), a.max_new) == (len(b.prompt), b.max_new)
            assert not np.array_equal(a.prompt[:8], b.prompt[:8])
    sizes = collections.Counter(
        (len(one.request(c, i).prompt), one.request(c, i).max_new)
        for c in range(one.clients) for i in range(spec["sizes_per_client"]))
    assert sizes == collections.Counter(
        map(tuple, traffic.design(spec).reshape(-1, 2).tolist()))


@pytest.mark.parametrize("name", MIXES)
def test_each_client_covers_every_stratum(name):
    """Row c of the design holds one point of each of the K strata of both
    lengths, and the lengths lie inside the mix's ranges."""
    spec = _mix(name)
    u = traffic.design_quantiles(spec)
    C, K, _ = u.shape
    assert (C, K) == (spec["clients"], spec["sizes_per_client"])
    for c in range(C):
        for col in (0, 1):
            assert sorted(np.floor(u[c, :, col] * K).astype(int)) \
                == list(range(K))
    rows = traffic.design(spec)
    for key, col in (("prompt_len", 0), ("max_new", 1)):
        assert rows[..., col].min() >= spec[key]["min"]
        assert rows[..., col].max() <= spec[key]["max"]
    assert sorted(u[..., 0].ravel()) == pytest.approx(
        [(j + 0.5) / (C * K) for j in range(C * K)])


def test_quantiles():
    lu = {"dist": "log_uniform", "min": 128, "max": 1024}
    assert traffic.quantile(lu, 0.0) == 128
    assert traffic.quantile(lu, 0.999999) == 1024
    assert traffic.quantile(lu, 1 / 3) == int(np.exp(np.log(128) + (np.log(1025)
                                                                    - np.log(128)) / 3))
    un = {"dist": "uniform", "min": 16, "max": 64}
    assert [traffic.quantile(un, u) for u in (0.0, 0.5, 0.99999)] == [16, 40, 64]
    with pytest.raises(ValueError):
        traffic.quantile({"dist": "zipf", "min": 1, "max": 2}, 0.5)


def test_open_loop_is_refused():
    with pytest.raises(ValueError):
        traffic.ClosedLoop(dict(_mix(MIXES[0]), loop="open"), 1, 10)
