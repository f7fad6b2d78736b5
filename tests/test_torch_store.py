"""The port's result store (``repro_torch.service.store``): TTL expiry,
size cap with LRU eviction, the env-var wiring, the timeline and
measurement sidecars (the reference's tests/test_store_hygiene.py and the
sidecar part of tests/test_recorder.py, on the port), and the port's own
rule: its records live in a ``repro_torch/`` subdirectory of the
reference's root, so neither package's clear, cap or eviction deletes the
other's records."""
from __future__ import annotations

import os
import time

import pytest

from repro_torch.core.engine import ExploreResult
from repro_torch.core.macro import TPDCIM_MACRO
from repro_torch.core.template import AcceleratorConfig
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.service import ResultStore, default_store
from repro_torch.service.store import PORT_DIR


def _result(tag: str = "x") -> ExploreResult:
    return ExploreResult(
        config=AcceleratorConfig(1, 1, 1, 2, 2),
        macro=TPDCIM_MACRO, workload="wl", objective="ee",
        strategy_set="st", per_op_strategy={"op0": "IS-W-F"},
        metrics={"tops_w": 1.0}, search={"method": "stub", "tag": tag},
    )


def _key(i: int) -> str:
    return f"{i:02d}" + "ab" * 31          # 64 hex-ish chars, distinct shards


def _capped_store(tmp_path, n_records: float) -> ResultStore:
    """A store whose cap holds about ``n_records`` records."""
    probe = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    probe.put(_key(0), _result())
    rec_bytes = os.path.getsize(probe._path(_key(0)))
    probe.clear()
    return ResultStore(str(tmp_path), ttl_s=None,
                       max_mb=n_records * rec_bytes / 1e6)


def test_ttl_expires_records(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=0.05, max_mb=None)
    store.put(_key(1), _result())
    assert _key(1) in store
    assert store.get(_key(1)) is not None
    time.sleep(0.08)
    assert _key(1) not in store, "membership must be TTL-aware"
    assert store.get(_key(1)) is None, "expired record must read as a miss"
    assert store.stats["expired"] == 1
    assert not os.path.exists(store._path(_key(1))), \
        "expired record must be deleted"
    store.put(_key(1), _result("fresh"))
    assert store.get(_key(1)).search["tag"] == "fresh"


def test_size_cap_evicts_least_recently_used(tmp_path):
    store = _capped_store(tmp_path, 3.5)
    for i in range(3):
        store.put(_key(i), _result(str(i)))
        time.sleep(0.02)                 # distinct mtimes
    assert store.get(_key(0)) is not None
    time.sleep(0.02)
    store.put(_key(3), _result("3"))     # overflows the cap -> evict LRU
    assert store.stats["evicted"] >= 1
    assert store.get(_key(1)) is None, "LRU record must be evicted"
    assert store.get(_key(0)) is not None, "recently-used record survives"
    assert store.get(_key(3)) is not None, "just-written record survives"


def test_limits_read_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CIM_TUNER_RESULT_STORE_TTL", "123.5")
    monkeypatch.setenv("CIM_TUNER_RESULT_STORE_MAX_MB", "2")
    store = ResultStore(str(tmp_path))
    assert store.ttl_s == 123.5
    assert store.max_bytes == 2e6
    monkeypatch.setenv("CIM_TUNER_RESULT_STORE_TTL", "not-a-number")
    monkeypatch.delenv("CIM_TUNER_RESULT_STORE_MAX_MB")
    store = ResultStore(str(tmp_path))
    assert store.ttl_s is None and store.max_bytes is None
    monkeypatch.setenv("CIM_TUNER_RESULT_STORE_TTL", "1")
    store = ResultStore(str(tmp_path), ttl_s=None, max_mb=0.5)
    assert store.ttl_s is None and store.max_bytes == 0.5e6


def test_uncapped_store_never_evicts(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    for i in range(5):
        store.put(_key(i), _result(str(i)))
    assert store.stats["evicted"] == 0
    assert len(store.keys()) == 5


_MEAS = [{"kernel": "cim_matmul", "bucket": "128x128x128", "tiling": "AF",
          "us": 12.5, "flops": 4.2e6, "bytes": 2.0e5, "seed": 0}]


def test_measurements_sidecar_round_trip(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    store.put(_key(1), _result())
    assert store.get_measurements(_key(1)) is None, \
        "no sidecar yet -> miss"
    store.put_measurements(_key(1), _MEAS)
    assert store.get_measurements(_key(1)) == _MEAS
    assert os.path.exists(store._measurements_path(_key(1)))


def test_measurements_sidecar_ttl_expires_with_parent(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=0.05, max_mb=None)
    store.put(_key(1), _result())
    store.put_measurements(_key(1), _MEAS)
    time.sleep(0.08)
    assert store.get(_key(1)) is None
    assert not os.path.exists(store._measurements_path(_key(1))), \
        "expired record must take its measurements sidecar with it"
    assert store.get_measurements(_key(1)) is None


def test_measurements_sidecar_recency_refreshed_on_hit(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    store.put(_key(1), _result())
    store.put_measurements(_key(1), _MEAS)
    sidecar = store._measurements_path(_key(1))
    mtime0 = os.path.getmtime(sidecar)
    time.sleep(0.05)
    assert store.get(_key(1)) is not None
    assert os.path.getmtime(sidecar) > mtime0, \
        "a hit on the parent must refresh the sidecar's LRU recency too"


def test_measurements_sidecar_evicted_with_parent(tmp_path):
    store = _capped_store(tmp_path, 3.5)
    for i in range(3):
        store.put(_key(i), _result(str(i)))
        store.put_measurements(_key(i), _MEAS)
        time.sleep(0.02)
    assert store.get(_key(0)) is not None     # key 1 becomes the LRU
    time.sleep(0.02)
    store.put(_key(3), _result("3"))
    assert store.get(_key(1)) is None, "LRU record must be evicted"
    assert not os.path.exists(store._measurements_path(_key(1))), \
        "eviction must remove the measurements sidecar, not orphan it"
    assert store.get_measurements(_key(0)) == _MEAS, \
        "surviving record keeps its sidecar"


def test_clear_removes_measurement_sidecars(tmp_path):
    store = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    store.put(_key(1), _result())
    store.put_measurements(_key(1), _MEAS)
    store.clear()
    assert store.get_measurements(_key(1)) is None
    assert not os.path.exists(store._measurements_path(_key(1)))


def _synthetic_timeline(key: str = "feedc0de") -> dict:
    rec = FlightRecorder(capacity=4)
    rec.start(key, method="portfolio", allocator="bandit",
              backends=["sa", "sobol"], total_evals=512, rungs=2, seed=0)
    rec.event(key, {"phase": "race", "allocator": "bandit", "rung": 0,
                    "best": 10.0, "pulls": {"sa": 1, "sobol": 1}})
    rec.finish(key, winner="sa", best=10.0, final=10.0)
    return rec.timeline(key)


def test_store_timeline_sidecar_roundtrip(tmp_path):
    store = ResultStore(str(tmp_path / "store"))
    tl = _synthetic_timeline()
    assert store.get_timeline("feedc0de") is None      # miss first
    store.put_timeline("feedc0de", tl)
    assert store.get_timeline("feedc0de") == tl
    path = store._timeline_path("feedc0de")
    with open(path, "w") as f:
        f.write("{not json")
    assert store.get_timeline("feedc0de") is None
    store.put_timeline("feedc0de", {"bad": object()})
    assert store.get_timeline("feedc0de") is None


# ------------------------------------------------------------------ #
# the port's subdirectory: port and reference records never meet
# ------------------------------------------------------------------ #
def test_records_live_in_the_port_subdirectory(tmp_path, monkeypatch):
    monkeypatch.setenv("CIM_TUNER_RESULT_STORE", str(tmp_path))
    monkeypatch.delenv("CIM_TUNER_DISABLE_RESULT_STORE", raising=False)
    store = default_store()
    assert store.root == os.path.join(str(tmp_path), PORT_DIR)
    store.put(_key(1), _result())
    assert store._path(_key(1)).startswith(
        os.path.join(str(tmp_path), PORT_DIR, _key(1)[:2]))
    monkeypatch.setenv("CIM_TUNER_DISABLE_RESULT_STORE", "1")
    assert default_store() is None


def _ref_result():
    pytest.importorskip("jax")
    from repro.core.engine import ExploreResult as RefResult
    from repro.core.macro import TPDCIM_MACRO as REF_MACRO
    from repro.core.template import AcceleratorConfig as RefConfig
    return RefResult(
        config=RefConfig(1, 1, 1, 2, 2), macro=REF_MACRO, workload="wl",
        objective="ee", strategy_set="st",
        per_op_strategy={"op0": "IS-W-F"}, metrics={"tops_w": 1.0},
        search={"method": "stub"})


@pytest.mark.parametrize("who_clears", ["reference", "port"])
def test_one_packages_clear_spares_the_others_records(tmp_path, who_clears):
    ref_result = _ref_result()
    from repro.service import ResultStore as RefStore
    ref_store, port_store = RefStore(str(tmp_path)), ResultStore(str(tmp_path))
    for i in range(3):
        ref_store.put(_key(i), ref_result)
        port_store.put(_key(i), _result())
        port_store.put_timeline(_key(i), _synthetic_timeline(_key(i)))
    assert len(ref_store.keys()) == len(port_store.keys()) == 3
    clearing, other = (ref_store, port_store) if who_clears == "reference" \
        else (port_store, ref_store)
    assert clearing.clear() == 3
    assert clearing.keys() == []
    assert len(other.keys()) == 3
    assert all(other.get(_key(i)) is not None for i in range(3))
    if other is port_store:
        assert port_store.get_timeline(_key(1)) is not None


def test_reference_size_cap_never_evicts_port_records(tmp_path):
    ref_result = _ref_result()
    from repro.service import ResultStore as RefStore
    port_store = ResultStore(str(tmp_path), ttl_s=None, max_mb=None)
    for i in range(4):
        port_store.put(_key(i), _result(str(i)))
    probe = RefStore(str(tmp_path / "probe"), ttl_s=None, max_mb=None)
    probe.put(_key(0), ref_result)
    rec_bytes = os.path.getsize(probe._path(_key(0)))
    ref_store = RefStore(str(tmp_path), ttl_s=None,
                         max_mb=1.5 * rec_bytes / 1e6)
    for i in range(4):
        ref_store.put(_key(10 + i), ref_result)
        time.sleep(0.01)
    assert ref_store.stats["evicted"] >= 2
    assert len(port_store.keys()) == 4
