"""The check rejects a broken timed path: a run with the program broken
underneath (the harness's look for a chip skipped) comes out not correct,
once for each fault the cell can have; and the control (the reference in
TF32 in the program's place) fails one of the cell's numbers."""
import pytest

from bench import harness
from bench.tests.tiny import tiny_root, workloads


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _half_batch(monkeypatch):
    from repro_torch.core import forecast

    plain = forecast.mse_loss

    def half(cfg, params, x, y):
        n = x.shape[-2] // 2
        return plain(cfg, params, x[..., :n, :], y[..., :n, :])

    monkeypatch.setattr(forecast, "mse_loss", half)


def _state_unchanged(monkeypatch, name):
    if name.startswith("fl-"):
        from repro_torch.core.fl import engine

        plain = engine._local_update_all

        def frozen(model_cfg, fl_cfg, meta, w, m, v, t, data, keys):
            _, m2, v2, t2, losses = plain(model_cfg, fl_cfg, meta, w, m, v, t,
                                          data, keys)
            return w, m2, v2, t2, losses

        monkeypatch.setattr(engine, "_local_update_all", frozen)
    else:
        from repro_torch.optim.adam import Adam

        monkeypatch.setattr(Adam, "update_", lambda self, p, g, s: (p, s))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", workloads())
def test_broken_program_is_not_correct(root, name, fault, monkeypatch):
    if fault == "half_batch":
        _half_batch(monkeypatch)
    else:
        _state_unchanged(monkeypatch, name)
    r = harness.run_cell(root, name, 424242, 0.1, False, "cpu")
    assert not r["correct"], r["checks"]


def _chunk_fault(monkeypatch, fault):
    """The while driver's chunks with the carry between them broken: the
    state a chunk returns is dropped (a captured chunk whose result is never
    copied back into the static state), or the key chain is not advanced."""
    from repro_torch.core.fl import engine

    plain = engine._while_chunk

    def broken(state, flags, *args, **kwargs):
        before = {k: v.clone() for k, v in (state if fault == "carry_dropped"
                                             else flags).items()}
        new_state, new_flags = plain(state, flags, *args, **kwargs)
        if fault == "carry_dropped":
            return before, new_flags
        return new_state, dict(new_flags, key=before["key"])

    monkeypatch.setattr(engine, "_while_chunk", broken)


@pytest.mark.parametrize("fault", ["carry_dropped", "keys_repeat"])
@pytest.mark.parametrize("name", [w for w in workloads() if w.startswith("fl-")])
def test_broken_chunk_carry_is_not_correct(root, name, fault, monkeypatch):
    _chunk_fault(monkeypatch, fault)
    r = harness.run_cell(root, name, 424243, 0.1, False, "cpu")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", workloads())
def test_control_fails_a_number(root, name):
    import time

    import torch

    ctx = harness.cell(root, name)
    ctx.seed, ctx.device, ctx.t_start = 31337, torch.device("cpu"), time.perf_counter()
    ctx.loop.setup(ctx)
    gaps = ctx.loop.reference_readings(ctx, "tf32")
    assert any(gaps[k] > v for k, v in ctx.limits.items()), gaps
