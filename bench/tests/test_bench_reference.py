"""The plain reference against the program at a tiny size on the CPU: the
same weights give the same forward pass, the flat layouts agree, and the
reference's federated job and training steps follow the program's."""
import math

import pytest
import torch

from bench import weights
from bench.reference import compare
from bench.reference import fl as ref_fl
from bench.reference import model as RM
from bench.reference import train as ref_train

MODELS = {
    "logtst": {"look_back": 32, "horizon": 2, "patch_len": 16, "stride": 8,
               "d_model": 16, "num_heads": 4, "d_ff": 32,
               "mixers": ["id", "id", "attn"], "dropout": 0.0, "revin": True,
               "use_flash_attn": True},
    "patchtst": {"look_back": 64, "horizon": 8, "patch_len": 16, "stride": 8,
                 "d_model": 16, "num_heads": 4, "d_ff": 32,
                 "mixers": ["attn", "attn", "attn"], "dropout": 0.0,
                 "revin": True, "use_flash_attn": True},
    "mlp": {"look_back": 32, "horizon": 4, "patch_len": 16, "stride": 8,
            "d_model": 16, "num_heads": 4, "d_ff": 32, "mixers": ["mlp", "id"],
            "dropout": 0.0, "revin": True, "use_flash_attn": False},
}


def _program_cfg(m):
    from repro_torch.core.forecast import ForecastConfig

    return ForecastConfig(**{k: tuple(v) if k == "mixers" else v
                             for k, v in m.items()})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_and_layout_match_the_program(name):
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core import forecast

    m = MODELS[name]
    flat, tree = weights.draw(m, 9, 1, "cpu")
    vec, meta = pt.tree_flatten_to_vector(tree)
    assert torch.equal(vec, flat)
    assert list(meta.paths) == [p for p, _, _ in RM.leaf_specs(m)]
    x = torch.randn(40, m["look_back"], generator=torch.Generator().manual_seed(1))
    want = forecast.forward(_program_cfg(m), tree, x)
    got = RM.forward(m, RM.unflatten(flat[None], m), x[None])[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cohort", [None, 3])
def test_fl_chunk_follows_run_fl(cohort):
    from repro_torch.core.fl.engine import FLConfig, run_fl

    from bench import datagen
    from bench.loops.fl_jobs import job_key

    m = MODELS["logtst"]
    fl = {"select_ratio": 0.5, "share_ratio": 0.3, "forward_ratio": 0.2,
          "local_steps": 2, "batch_size": 4, "lr": 1e-3, "adam_b1": 0.9,
          "adam_b2": 0.999, "adam_eps": 1e-8}
    train, test = (torch.from_numpy(a) for a in
                   datagen.ev_fleet(3, 6, 120, m["look_back"], m["horizon"], True))
    flat, tree = weights.draw(m, 3, 2, "cpu")
    cfg = FLConfig(num_clients=6, participation=cohort, streaming_windows=True,
                   use_pallas_mix=True, **{k: v for k, v in fl.items()})
    key = job_key(3, 2, "cpu")
    hist = run_fl(_program_cfg(m), cfg, train, test, key, max_rounds=4,
                  patience=9, eval_every=2, driver="while", init_params=tree,
                  device="cpu")
    ref = ref_fl.run_job(m, fl, flat, key, train, test, cohort or 6, 4, 2)
    prog = {"loss": hist["train_loss"], "comm": hist["comm"],
            "rmse": [r for _, r in hist["rmse"]], "start": flat,
            "final": hist["state"]["w_global"]}
    sizes = [math.prod(s) for _, s, _ in RM.leaf_specs(m)]
    gaps = compare.fl_gaps(prog, dict(ref, start=flat), 3, sizes)
    assert len(ref["rmse"]) == 2 and gaps["comm_gap"] == 0.0
    assert all(v < 1e-5 for v in gaps.values()), gaps


def test_train_steps_follow_the_programs_adam():
    from repro_torch.common import pytree_utils as pt
    from repro_torch.core.forecaster import Forecaster
    from repro_torch.optim.adam import Adam
    from repro_torch.optim.schedules import one_cycle

    m = MODELS["patchtst"]
    opt_cfg = {"max_lr": 1e-3, "cycle_steps": 10, "b1": 0.9, "b2": 0.999,
               "eps": 1e-8, "grad_clip": 1.0}
    start, tree = weights.draw(m, 4, 0, "cpu")
    params = pt.tree_map(torch.clone, tree)
    opt = Adam(lr=one_cycle(1e-3, 10), grad_clip=1.0)
    state = opt.init(params)
    fc = Forecaster(_program_cfg(m))
    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn(24, 64, generator=g), torch.randn(24, 8, generator=g))
               for _ in range(3)]
    losses = []
    for i, (x, y) in enumerate(batches):
        (loss, _), grads = pt.value_and_grad(
            lambda p, a, b: (fc.loss_fn(p, a, b), None), params, x, y)
        opt.update_(params, grads, state)
        losses.append(float(loss))
        if i == 0:
            grad1 = weights.flat_of(state["m"], m) / 0.1
    prog = {"loss": losses, "grad1": grad1, "start": start,
            "params": weights.flat_of(params, m)}
    ref = dict(ref_train.train_steps(m, opt_cfg, start, batches), start=start)
    sizes = [t.numel() for t in pt.leaves(tree)]
    gaps = compare.train_gaps(prog, ref, sizes)
    assert all(v < 1e-4 for v in gaps.values()), gaps


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    assert RM._tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
