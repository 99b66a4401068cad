"""What decides ``correct``: the program passes, the control (the reference
in bfloat16) fails, and a run with the timed path broken underneath comes
out not correct, for every fault a cell can have. On the CPU at small
sizes; the chip's readings at the cells' sizes are ``calibrate``'s."""
import dataclasses

import pytest

from spgemm_bench import cells, harness

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
SEED = 2**31 + 101


def _fault(kind: str):
    """A function that breaks a CSR output as ``kind`` says: ``stale``
    hands back the first output it saw on every call (a step that returns
    its state unchanged); ``half`` leaves the rows of the lower half out
    (their values 0); ``value`` alters one value by 1%; ``column`` moves
    one entry to another column."""
    first = []

    def broken(c):
        if kind == "stale":
            if not first:
                first.append(c)
            return first[0]
        vals, colidx = c.vals.clone(), c.colidx.clone()
        nnz = int(c.rowptr[-1])
        if kind == "half":
            vals[int(c.rowptr[c.shape[0] // 2]):nnz] = 0
        elif kind == "value":
            vals[nnz // 2] *= 1.01
        elif kind == "column":
            colidx[nnz // 2] = (colidx[nnz // 2] + 1) % c.shape[1]
        return dataclasses.replace(c, vals=vals, colidx=colidx)
    return broken


def _break(monkeypatch, cell: dict, kind: str) -> None:
    """Break the program's timed entry of ``cell`` underneath the run."""
    driver = cell["traffic_data"]["driver"]
    broken = _fault(kind)
    if driver == "reuse":
        from spgemm_bench.drivers import reuse

        planned = reuse.Driver._planned

        def _planned(self, method, plans):
            fn = planned(self, method, plans)
            return lambda x: broken(fn(x))
        monkeypatch.setattr(reuse.Driver, "_planned", _planned)
    elif driver == "oneshot":
        from benchmark_spgemm_using_csr_tpu_torch import api

        spgemm = api.spgemm
        monkeypatch.setattr(api, "spgemm",
                            lambda *a, **k: broken(spgemm(*a, **k)))
    elif driver == "refresh":
        from benchmark_spgemm_using_csr_tpu_torch.models import amg

        refresh = amg.numeric_refresh
        seen = []

        def numeric_refresh(h, a):
            out = refresh(h, a)
            if kind == "stale":
                seen.append(out)
                return seen[0]
            out.levels[1] = dataclasses.replace(
                out.levels[1], a=broken(out.levels[1].a))
            return out
        monkeypatch.setattr(amg, "numeric_refresh", numeric_refresh)
    else:
        raise AssertionError(driver)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(small_root, name):
    cell = cells.load(name, small_root)
    ok = harness.run(cell, SEED, 0.2, False, "cpu")
    assert ok["correct"] and ok["failed"] == 0 and ok["attempted"] > 0
    low = ok["checks"]["val_err"]["value"]
    ctrl = harness.run(cell, SEED + 1, 0.2, False, "cpu", control=True)
    assert not ctrl["correct"]
    high = ctrl["checks"]["val_err"]["value"]
    limit = cell["limits"]["val_err"]
    assert low < limit < high and high > 3 * low


@pytest.mark.parametrize("kind", ["stale", "half", "value", "column"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, name,
                                            kind):
    cell = cells.load(name, small_root)
    _break(monkeypatch, cell, kind)
    r = harness.run(cell, SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["failed"] > 0


def test_the_sample_is_drawn_from_the_seed():
    def taken(seed, calls=1000):
        sample = harness.Sample(3, seed)
        return [i for i in range(calls) if sample.due((i + 1) / calls)]
    a = taken(5)
    assert a == taken(5) and len(a) == 3
    assert taken(6) != a
    assert max(a) > 3  # not only the first calls
    one = harness.Sample(3, 5)
    assert one.due(1.0) and not one.due(2.0)  # each instant is taken once


def test_the_kept_outputs_are_host_copies_left_out_of_the_window():
    """A kept output is the call's own, copied to the host, and the time
    its copy takes is not counted in the window's seconds."""
    import time

    import torch

    copy_s = 0.1

    class Slow:
        def __init__(self, x):
            self.x = x

        def to(self, device, copy=False):
            time.sleep(copy_s)
            return self.x.to(device, copy=copy)

    class Driver:
        def prepare(self, i):
            return i

        def call(self, x):
            return torch.full((4,), float(x))

        def outputs(self, out):
            return [(Slow(out),)]

    sample = harness.Sample(3, SEED)
    t0 = time.perf_counter()
    seconds = harness._window(Driver(), sample, [], 1.0, "cpu")
    elapsed = time.perf_counter() - t0
    copies = len(sample.kept) * copy_s
    assert sample.kept and all(float(o[0][0][0]) == i
                               for i, o in sample.kept.items())
    # every copy but perhaps the last one, made once the window had ended
    assert elapsed - copies - 0.05 <= seconds
    assert seconds <= elapsed - copies + copy_s + 0.05


@pytest.mark.parametrize("method", ["grouped", "tilepack", "chunked", "dia"])
def test_every_planned_path_of_the_reuse_driver_is_right(small_root, method):
    """The reuse driver's planned phase of each pick it can meet, held
    against the reference on the small circuit (dia and tilepack, whose
    plan takes short uniform rows only, on the small stencil), whatever
    the dispatcher would pick there."""
    from spgemm_bench.drivers import reuse
    from spgemm_bench.reference import compare

    name = "poisson2d_724.reuse" if method in ("dia", "tilepack") \
        else "circuit_262k.reuse"
    d = reuse.Driver(cells.load(name, small_root), SEED, "cpu")
    d.make_matrix()
    d.ops = [d.operand(k) for k in range(d.k)]
    fn = d._planned(method, {})
    for i in (0, 1):
        out = d.outputs(fn(d.prepare(i)))[0]
        r = compare.compare(*out, d.reference(i)[0])
        assert r["struct_mismatch"] == 0 and r["val_err"] < 1e-5


def test_the_oneshot_driver_keeps_the_structure_in_new_tensors_unpermuted(
        small_root):
    """With the traffic's ``permute`` false, every call's operand has A's
    own structure and its value set, in tensors of its own, and its output
    passes against the reference on the small stencil; the default still
    permutes (the circuit's one-shot traffic)."""
    import torch

    from spgemm_bench.drivers import oneshot
    from spgemm_bench.reference import compare

    d = oneshot.Driver(cells.load("poisson2d_724.oneshot", small_root), SEED,
                       "cpu")
    assert d.traffic["permute"] is False
    d.make_matrix()
    d.method = d.traffic["method"]
    rowptr, colidx, _ = d.structure
    nnz = int(rowptr[-1])
    held = [rowptr, colidx, d.vals]
    for i in (0, 1, 9):
        x = d.prepare(i)
        assert torch.equal(x.rowptr, rowptr)
        assert torch.equal(x.colidx[:nnz], colidx[:nnz])
        assert torch.equal(x.vals[:nnz], d.vals[i % d.k, :nnz])
        ptrs = {t.data_ptr() for t in held}
        assert not {t.data_ptr() for t in (x.rowptr, x.colidx, x.vals)} \
            & ptrs
        held += [x.rowptr, x.colidx, x.vals]
        out = d.outputs(d.call(x))[0]
        r = compare.compare(*out, d.reference(i)[0])
        assert r["struct_mismatch"] == 0 and r["val_err"] < 1e-5
    c = oneshot.Driver(cells.load("circuit_262k.oneshot", small_root), SEED,
                       "cpu")
    assert "permute" not in c.traffic
    c.make_matrix()
    nnz = int(c.structure[0][-1])
    assert not torch.equal(c.prepare(0).colidx[:nnz], c.structure[1][:nnz])
