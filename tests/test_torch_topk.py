"""The port's top-k selections against the JAX package's, on the CPU:

- ``topk_abs`` for ``impl`` exact, approx and oversample against the
  reference's, index for index: random vectors with planted ties, all
  zeros, all equal, negative zeros, k = 1 (where the reference's CPU
  ``approx_max_k`` keeps the LAST of tied maxima), and 4k >= d (oversample
  falls through to exact); the reference's ``recall``, which the port
  does not take, changes nothing off a TPU;
- ``unsketch_topk`` with ``UNSKETCH_SINGLE_SHOT_BYTES`` at 0 in both
  packages (the chunk scan), every impl, both hash families, against the
  reference's scan: the same indices and bitwise-equal values, k above
  the valid coordinates included (the unfilled entries idx -1, value 0),
  and an all-zero table, where every estimate ties (at k = 1 approx the
  random family's block scan keeps the first block's last tie, as the
  reference's does, where one selection over d would keep the last);
  the port's scan against the port's single shot;
- the modes select through every impl (the server step of true_topk with
  approx and oversample releases what exact releases);
- phase 26c of ``chip_smoke.py`` (``unsketch_check``) at a small d, the
  single shot on the CPU standing in for the card's.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.sketch import csvec as jcsvec
from commefficient_tpu_torch.modes import modes as tmodes
from commefficient_tpu_torch.modes.config import ModeConfig as TModeConfig
from commefficient_tpu_torch.sketch import csvec

torch.set_num_threads(2)
IMPLS = ("exact", "approx", "oversample")


def _vectors():
    rng = np.random.RandomState(0)
    x = rng.standard_normal(5000).astype(np.float32)
    x[::7] = 0.0
    x[5::11] = x[3]  # ties at one magnitude, both signs
    x[6::13] = -x[3]
    return {
        "random_ties": x,
        "all_zero": np.zeros(300, np.float32),
        "negative_zero": -np.zeros(300, np.float32),
        "all_equal": np.full(300, -2.5, np.float32),
        "few_levels": rng.randint(-3, 4, size=1000).astype(np.float32),
    }


VECTORS = _vectors()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(VECTORS))
@pytest.mark.parametrize("k", [1, 2, 17, 100])
def test_topk_abs_matches_reference(name, impl, k):
    x = VECTORS[name]
    want = np.asarray(jcsvec.topk_abs(jnp.asarray(x), k, impl=impl))
    got = csvec.topk_abs(torch.from_numpy(x), k, impl=impl)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["approx", "oversample"])
def test_topk_abs_reference_recall_changes_nothing_and_oversample_falls_through(impl):
    x = VECTORS["random_ties"]
    t = torch.from_numpy(x)
    got = csvec.topk_abs(t, 50, impl=impl)
    assert torch.equal(got, csvec.topk_abs(t, 50))
    for recall in (0.5, 0.95, 1.0):
        want = np.asarray(jcsvec.topk_abs(jnp.asarray(x), 50, recall=recall, impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)
    # 4k >= d: the candidates would be every entry, so exact (k = 1 of 4
    # entries included)
    for d, k in ((40, 10), (40, 11), (4, 1)):
        want = np.asarray(jcsvec.topk_abs(jnp.asarray(x[:d]), k, impl=impl))
        np.testing.assert_array_equal(csvec.topk_abs(t[:d], k, impl=impl).numpy(), want)
    with pytest.raises(ValueError, match="bad impl"):
        csvec.topk_abs(t, 3, impl="fast")


def _table(family, d, c, r, seed=3):
    rng = np.random.RandomState(seed)
    v = rng.normal(0, 0.01, size=d).astype(np.float32)
    v[rng.choice(d, 30, replace=False)] = 25.0
    v[rng.choice(d, 40, replace=False)] = 0.0
    spec = csvec.CSVecSpec(d=d, c=c, r=r, seed=seed, family=family,
                           num_blocks=4 if family == "random" else 1)
    jspec = jcsvec.CSVecSpec(d=d, c=c, r=r, seed=seed, family=family,
                             num_blocks=spec.num_blocks)
    return spec, jspec, csvec.sketch_vec(spec, torch.from_numpy(v))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", ["rotation", "random"])
@pytest.mark.parametrize("k", [1, 30, 700])
def test_unsketch_scan_matches_reference(monkeypatch, family, impl, k):
    spec, jspec, t = _table(family, 10_000, 1024, 3)
    single = csvec.unsketch_topk(spec, t, k, impl=impl)
    monkeypatch.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    monkeypatch.setattr(jcsvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    ji, jv = jcsvec.unsketch_topk(jspec, jnp.asarray(t.numpy()), k, impl=impl)
    ti, tv = csvec.unsketch_topk(spec, t, k, impl=impl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the port's scan against the port's single shot
    assert torch.equal(ti, single[0]) and torch.equal(tv, single[1])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", ["rotation", "random"])
@pytest.mark.parametrize("k", [1, 5])
def test_unsketch_scan_all_ties_matches_reference(monkeypatch, family, impl, k):
    """An all-zero table ties every estimate: the scan's per-chunk
    preselect and the carry-first merge pick what the reference's do."""
    spec, jspec, _ = _table(family, 10_000, 1024, 3)
    t = csvec.zero_table(spec, torch.device("cpu"), torch.float32)
    if family == "random":
        # the random family scans block by block at any ceiling
        ji, jv = jcsvec.unsketch_topk(jspec, jnp.asarray(t.numpy()), k, impl=impl)
        ti, tv = csvec.unsketch_topk(spec, t, k, impl=impl)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    monkeypatch.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    monkeypatch.setattr(jcsvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    ji, jv = jcsvec.unsketch_topk(jspec, jnp.asarray(t.numpy()), k, impl=impl)
    ti, tv = csvec.unsketch_topk(spec, t, k, impl=impl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", IMPLS)
def test_unsketch_scan_unfilled_entries(monkeypatch, impl):
    """k above the coordinates: the scan's unfilled entries keep idx -1
    and value 0, as the reference's do."""
    spec, jspec, t = _table("rotation", 50, 16, 3)
    monkeypatch.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    monkeypatch.setattr(jcsvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
    ji, jv = jcsvec.unsketch_topk(jspec, jnp.asarray(t.numpy()), 50, impl=impl)
    ti, tv = csvec.unsketch_topk(spec, t, 50, impl=impl)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["approx", "oversample"])
@pytest.mark.parametrize("mode", ["true_topk", "sketch"])
def test_modes_select_through_every_impl(impl, mode):
    """A server step with approx or oversample releases what exact
    releases (their selections are exact off a TPU)."""
    rng = np.random.RandomState(5)
    d = 3000
    kw = dict(mode=mode, d=d, k=40, num_cols=512 if mode == "sketch" else 0, num_rows=3)
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    outs = []
    for which in ("exact", impl):
        cfg = TModeConfig(topk_impl=which, topk_recall=0.5, **kw)
        agg = {"table": csvec.sketch_vec(cfg.sketch_spec, g)} if mode == "sketch" else {"dense": g}
        outs.append(tmodes.server_step_sparse(cfg, agg, tmodes.init_server_state(cfg, "cpu"),
                                              0.1))
    (da, sa), (db, sb) = outs
    assert torch.equal(da["idx"], db["idx"]) and torch.equal(da["vals"], db["vals"])
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_phase_26c_unsketch_check_at_small_d(monkeypatch):
    """``chip_smoke.unsketch_check`` (phase 26c) at d = 20,000: the single
    shot (on the CPU here) against the chunk scan of the same table."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    spec, _, t = _table("rotation", 20_000, 2048, 5)
    with monkeypatch.context() as m:
        m.setattr(csvec, "UNSKETCH_SINGLE_SHOT_BYTES", 0)
        scanned = csvec.unsketch_topk(spec, t.clone(), 500)
    verdict = chip_smoke.unsketch_check(csvec, spec, t, 500, scanned)
    assert "== the CPU chunk scan over 10 slabs" in verdict
    bad = (scanned[0].flip(0), scanned[1])
    with pytest.raises(SystemExit, match="differ"):
        chip_smoke.unsketch_check(csvec, spec, t, 500, bad)
