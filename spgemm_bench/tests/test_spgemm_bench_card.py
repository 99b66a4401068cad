"""On the card (``cuda``; they skip without one): every cell's run at a
small size, untraced and traced, reads its device numbers, and the control
fails there too. ``python3 -m pytest spgemm_bench/tests -m cuda -q``."""
import pytest

from spgemm_bench import cells, harness

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_card_reads_its_device_numbers(small_root, card, name):
    cell = cells.load(name, small_root)
    plain = harness.run(cell, 2**31 + 11, 0.5, False, card)
    assert plain["correct"] and plain["device"]["platform"] == "gpu"
    assert plain["device"]["memory_peak_bytes"] > 0
    assert _metric(plain, "peak_gib") > 0
    traced = harness.run(cell, 2**31 + 12, 0.5, True, card)
    assert traced["correct"]
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < _metric(traced, "numeric_roofline") <= 100
    assert 0 <= _metric(traced, "device.idle_share") < 100
    assert _metric(traced, "numeric.device_ms") > 0
    assert traced["breakdown"]["device_ops"]


def _metric(result: dict, name: str) -> float:
    """The value of ``name``, or of its twin in the cell's class."""
    metrics = result["metrics"]
    for key in (name, "oneshot_" + name, "oneshot." + name, "paced_" + name,
                "paced." + name, "refresh_" + name, "refresh." + name):
        if key in metrics:
            return metrics[key]["value"]
    raise KeyError(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(small_root, card, name):
    cell = cells.load(name, small_root)
    r = harness.run(cell, 2**31 + 13, 0.2, False, card, control=True)
    assert not r["correct"]
    assert r["checks"]["val_err"]["value"] > cell["limits"]["val_err"]
