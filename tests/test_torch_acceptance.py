"""The port's acceptance driver (``scripts/acceptance.py``) at its small
sizes on the CPU: all five configs pass, each held against scipy (config 5
over 8 spawned gloo ranks), and the run exits 1 when a config's result is
wrong or when it asks for a card that is not there."""
import json

import pytest
import torch

from benchmark_spgemm_using_csr_tpu_torch.scripts import acceptance

torch.set_num_threads(2)


def rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_acceptance_small_passes_every_config(tmp_path, capsys):
    out = tmp_path / "results.jsonl"
    assert acceptance.main(["--small", "--device", "cpu",
                            "--results", str(out)]) == 0
    got = rows(out)
    assert [r["config"] for r in got] == [
        f"acceptance/{name}" for name, _ in acceptance.CONFIGS]
    assert all(r["ok"] for r in got)
    assert "8 gloo ranks" in got[-1]["detail"]
    assert "ACCEPTANCE: ALL PASS" in capsys.readouterr().out


def test_acceptance_exits_1_on_a_wrong_result(tmp_path, monkeypatch, capsys):
    """The hash config's C with its values doubled fails its check against
    scipy, and the run exits 1 (config 5, whose ranks the passing run
    covers, is left out here)."""
    hash_fn = acceptance.spgemm_hash

    def doubled(a, b):
        c = hash_fn(a, b)
        return type(c)(c.rowptr, c.colidx, c.vals * 2, c.shape)

    monkeypatch.setattr(acceptance, "spgemm_hash", doubled)
    monkeypatch.setattr(acceptance, "CONFIGS", acceptance.CONFIGS[:4])
    out = tmp_path / "results.jsonl"
    assert acceptance.main(["--small", "--device", "cpu",
                            "--results", str(out)]) == 1
    assert [r["ok"] for r in rows(out)] == [True, True, True, False]
    text = capsys.readouterr().out
    assert "[FAIL] 4-powerlaw-hash-path" in text
    assert "ACCEPTANCE: FAILURES" in text


def test_acceptance_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        acceptance.main(["--small", "--results", str(tmp_path / "r.jsonl")])
