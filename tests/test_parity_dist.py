"""Small-N re-check of the distribution-level parity harness
(scripts/parity_dist.py — VERDICT r4 Next #2).

The harness's full statement is 200 episodes/side; this test re-runs a
scaled-down version (fewer episodes, smaller K) in CI so the harness
itself — both episode loops, the metrics, and the statistics — stays
exercised. Bands are loose (16 episodes has little KS power).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))


@pytest.fixture(scope="module")
def pd():
    import parity_dist

    return parity_dist


def test_cartpole4_small_n(pd, monkeypatch):
    monkeypatch.setattr(pd, "K_CART", 2048)
    monkeypatch.setattr(pd, "N_TICKS_CART", 60)  # 6 s
    n = 16
    lib = pd.run_library_cartpole4(n)
    ora = pd.run_oracle_side("cartpole4", n, jobs=2)
    s = pd.summarize("cartpole4-small", lib, ora)
    assert s["library"]["survival"] == 1.0
    assert s["oracle"]["survival"] == 1.0
    # same regulation regime: mean θ-RMS within 60% relative (16 episodes)
    ml, mo = s["library"]["rms_theta_mean"], s["oracle"]["rms_theta_mean"]
    assert abs(ml - mo) < 0.6 * max(ml, mo), (ml, mo)
    assert s["tests"]["ks_rms_theta"]["p"] > 1e-3


def test_cartpole4_est_small_n(pd, monkeypatch):
    """Small-N re-check of the round-5 fifth config: the cartpole4 FLEET
    stack with its UKF(4,3) in the loop (20 Hz control, 5 substeps at
    100 Hz) vs the C++ oracle driver."""
    monkeypatch.setattr(pd, "N_TICKS_CART_EST", 60)  # 3 s
    n = 12
    lib = pd.run_library_fleet("cartpole4", pd.K_CART_EST,
                               pd.N_TICKS_CART_EST, n, feed_true=False)
    ora = pd.run_oracle_side("cartpole4-est", n, jobs=2)
    s = pd.summarize("cartpole4-est-small", lib, ora)
    assert s["library"]["survival"] == 1.0
    assert s["oracle"]["survival"] == 1.0
    ml, mo = s["library"]["rms_theta_mean"], s["oracle"]["rms_theta_mean"]
    assert abs(ml - mo) < 0.6 * max(ml, mo), (ml, mo)
    assert s["tests"]["ks_rms_theta"]["p"] > 1e-3


def test_qp_parking_small_n(pd):
    r = pd.run_qp_parking(8)
    assert r["flag_agreement"] == 1.0
    assert r["library_park_rate"] == 1.0 and r["oracle_park_rate"] == 1.0
    assert r["max_final_state_diff"] < 1e-4
