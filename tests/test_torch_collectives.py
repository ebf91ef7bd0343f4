"""The sharded steps' collectives (``launch.mesh.accounting_group`` /
``device_mesh``, ``sharding.rules.spec_to_placements``,
``launch.api.distribute_structs``, ``launch.cost.collective_bytes``, the
dry run's ``collectives``, PSGF-DP with the pod as a mesh axis).

Every case that opens a process group does so in a child process, so that
no default group is left in the test worker: the children start together
at the first test that needs one (a ``fake`` group of the production
meshes' 512 ranks for the accounting cases, one for the model steps on a
(2, 2, 2) mesh, a real one-rank gloo group on the CPU, a real gloo group
of four ranks, a (2, 2) mesh on which every shard holds data, for the
sharded arithmetic and its peak, and the reference on 8 XLA host
devices), and each prints one JSON report (the four ranks' group through
rank 0). The bytes model and the cross-pod classifier are held against the
reference's own parser (``repro.launch.hlo_analysis``) on the HLO lines
the same collectives would be, and the per-device counts of single ops
against its ``cost_summary`` and ``memory_summary``.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from distributed_utils import child_env  # noqa: E402

REFERENCE_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute", "total", "count", "cross_pod"}

_ACCOUNTING_CHILD = r"""
import json
import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.common import pytree_utils as pt
from repro_torch.core import psgf_dp as P
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch.api import distribute_structs
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import make_optimizer, sharded_train_inputs
from repro_torch.optim import Adam
from repro_torch.sharding.rules import make_rules

R_ = Replicate()
out = {}
with M.accounting_group(512):
    try:
        with M.accounting_group(8):
            out["nested"] = "opened"
    except RuntimeError as e:
        out["nested"] = str(e)
    dm = M.device_mesh(M.AbstractMesh(("pod", "data", "model"), (2, 2, 2)))
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    ops = {
        "all-reduce": lambda ax, dt: funcol.all_reduce(meta((16, 8), dt), "sum", dm.get_group(ax)),
        "all-gather": lambda ax, dt: funcol.all_gather_tensor(meta((8, 4), dt), 0, dm.get_group(ax)),
        "reduce-scatter": lambda ax, dt: funcol.reduce_scatter_tensor(
            meta((16, 4), dt), "sum", 0, dm.get_group(ax)),
        "all-to-all": lambda ax, dt: funcol.all_to_all_single(meta((8, 4), dt), None, None,
                                                              dm.get_group(ax)),
    }
    out["ops"] = {f"{op}|{ax}|{dt}": cost.collective_bytes(fn, ax, getattr(torch, dt),
                                                          pod_size=4)
                  for op, fn in ops.items() for ax in ("model", "pod")
                  for dt in ("float32", "bfloat16")}
    # DTensor's all-to-all on a CPU mesh (Gloo has none: it falls back)
    x = DTensor.from_local(meta((4, 8), torch.float32), dm, [R_, R_, Shard(0)],
                           run_check=False, shape=(8, 8), stride=(8, 1))
    out["redistribute"] = cost.collective_bytes(
        lambda: x.redistribute(dm, [R_, R_, Shard(1)]), pod_size=4)

    # PSGF-DP's syncs over pod-split DTensors
    glob0 = {"a": meta((4, 8), torch.float32), "b": meta((6,), torch.bfloat16)}
    local = P.stack_for_pods(glob0, 2, dm)
    glob = P.on_mesh(glob0, dm)
    none = {"a": False, "b": False}
    syncs = {}
    for name, share, fwd in (("unshared", none, none),
                             ("shared_a", {"a": True, "b": False}, none),
                             ("shared_a_forward_b", {"a": True, "b": False},
                              {"a": False, "b": True})):
        syncs[name] = cost.collective_bytes(P.psgf_sync_static, local, glob, share,
                                            fwd, (True, False), pod_size=4)
    syncs["full"] = cost.collective_bytes(P.full_sync, local, 2, pod_size=4)
    from repro_torch import random as R
    syncs["traced"] = cost.collective_bytes(
        P.psgf_sync, local, glob, R.PRNGKey(0, device="meta"), P.PSGFDPConfig(), 2,
        pod_size=4)
    out["syncs"] = syncs
    out["leaf_bytes"] = {"a": 4 * 8 * 4, "b": 6 * 2}
    out["pod_split"] = [p.is_shard(0) for p in local["a"].placements]
    out["global_whole"] = [p.is_replicate() for p in glob["a"].placements]

    # the local step: each rank's pods on its own shard
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    opt = Adam(lr=lambda t: 1e-2)
    step = P.make_local_train_step(loss_fn, opt, mesh=dm)
    stacked = P.stack_for_pods({"w": torch.zeros((3, 1))}, 4, dm)
    pod = (Shard(0), R_, R_)
    batch = {"x": distribute_tensor(torch.ones((4, 8, 3)), dm, pod),
             "y": distribute_tensor(torch.ones((4, 8, 1)), dm, pod)}
    out["local_step"] = cost.collective_bytes(
        step, stacked, P.init_pod_opt_state(opt, stacked), batch, pod_size=4)

    # every config's params on both production meshes, on meta
    bad = []
    for multi in (False, True):
        am = M.make_production_mesh(multi_pod=multi)
        pm = M.device_mesh(am)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            structs = sharded_train_inputs(cfg, SHAPES["train_4k"], make_rules(am, "train"),
                                           make_optimizer(cfg))[0]
            laid = distribute_structs(structs, pm)
            for s, d in zip(pt.leaves(structs), pt.leaves(laid)):
                if tuple(d.to_local().shape) != tuple(s.shard_shape) or d.shape != s.shape:
                    bad.append([arch, multi, list(s.shape), list(s.shard_shape)])
            out.setdefault("leaves", 0)
            out["leaves"] += len(pt.leaves(structs))
    out["bad_shards"] = bad

    # the serve steps on a mesh take the serve rules, which lay out their
    # inputs
    from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                          sharded_serve_inputs)
    from repro_torch.launch.shapes import InputShape
    cfg = get_config("qwen2-1.5b").reduced()
    serve = {}
    for kind, build in (("prefill", build_prefill_step), ("decode", build_serve_step)):
        fn, api, rules = build(cfg, "meta", mesh=dm)
        params, rest = sharded_serve_inputs(cfg, InputShape("d", 64, 8, kind), rules)
        args = ((rest,) if kind == "prefill" else (rest["cache"], rest["token"], 63))
        with torch.no_grad():
            got = cost.collective_bytes(
                fn, distribute_structs(params, dm),
                *[a if isinstance(a, int) else distribute_structs(a, dm) for a in args],
                pod_size=4)
        serve[kind] = {"rules": rules.table == make_rules(
                           M.AbstractMesh(("pod", "data", "model"), (2, 2, 2)), "serve").table,
                       "total": got["total"]}
    out["serve"] = serve

    # single ops over DTensors on the (2, 2, 2) mesh, per device, beside the
    # reference's summaries of the same ops on 8 XLA host devices
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def laid(shape, placements):
        local, _ = compute_local_shape_and_global_offset(shape, dm, placements)
        return DTensor.from_local(meta(local, torch.float32), dm, placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    rows, cols = (R_, Shard(0), R_), (R_, R_, Shard(1))
    single = {
        "dot_rows": (lambda x, w: x @ w, laid((64, 32), rows), laid((32, 48), (R_,) * 3)),
        "dot_contract": (lambda x, w: (x @ w).redistribute(dm, (R_,) * 3),
                         laid((64, 32), cols), laid((32, 48), (R_, R_, Shard(0)))),
        "exp": (torch.exp, laid((64, 32), (R_, Shard(0), Shard(1)))),
        "tanh": (torch.tanh, laid((64, 32), (R_, Shard(0), Shard(1)))),
        "row_sum": (lambda x: x.sum(dim=1), laid((64, 32), rows)),
    }
    out["single_ops"] = {}
    for name, (fn, *args) in single.items():
        with torch.no_grad():
            got = cost.account(fn, *args, pod_size=4)
        out["single_ops"][name] = {k: got[k] for k in (
            "flops", "bytes_accessed", "transcendentals", "argument_bytes",
            "output_bytes", "alias_bytes")}

out["after"] = torch.distributed.is_initialized()
# the dry run's own accounting group from here on (one per process)
# reduced qwen2's train step on a (1, 1) mesh: the one-device step
import dataclasses
from repro_torch.launch import dryrun as DR
from repro_torch.launch.shapes import InputShape
small = get_config("qwen2-1.5b").reduced()
shape = InputShape("x", 32, 2, "train")
one = DR.count_step(small, shape, M.AbstractMesh(("data", "model"), (1, 1)))
out["one_by_one"] = {"flops": one["flops"],
                     "flops_global": DR.count_flops(small, shape)["flops"],
                     "peak": one["peak_bytes"],
                     "one_device_peak": DR.one_device_peak(small, 2, 32)["peak_bytes"]}
# a whole record on the production mesh
out["record"] = DR.account_combo("qwen2-1.5b", "train_4k", True, cfg_override=small)
# the estimates of the four gloo ranks' steps (the same optimizer's
# memory: Adam with float32 moments)
four = M.AbstractMesh(("data", "model"), (2, 2))
out["four_rank_estimates"] = {}
for arch in ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    got = DR.count_step(cfg, InputShape("x", 16, 4, "train"), four,
                        Adam(lr=lambda t: 1e-3, eps=1.0))
    out["four_rank_estimates"][arch] = got["peak_bytes"]
print(json.dumps(out))
"""

_STEPS_CHILD = r"""
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.shapes import InputShape

mesh = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
shape = InputShape("t", 16, 8, "train")
out = {}
for arch in ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4)
    fit = DR.count_step(cfg, shape, mesh, extrapolate=True)
    direct = DR.count_step(cfg, shape, mesh, extrapolate=False)
    out[arch] = {"fit": fit, "direct": direct}
    # torch's own counter over the same step
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as comm:
        out[arch]["depth1"] = DR.step_collectives(
            dataclasses.replace(cfg, num_layers=1), shape, mesh)["count"]
    out[arch]["comm_debug_depth1"] = sum(comm.get_comm_counts().values())
print(json.dumps(out))
"""

_ONE_RANK_CHILD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.configs import get_config
from repro_torch.core import psgf_dp as P
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch.api import distribute_structs
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step, sharded_train_inputs
from repro_torch.launch.train import make_batch
from repro_torch.optim import Adam, one_cycle
from repro_torch.sharding.rules import make_rules

dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=0,
                        world_size=1)
out = {}
try:
    M.accounting_group(8).__enter__()
except RuntimeError as e:
    out["refused"] = str(e)

# PSGF-DP's local step on a one-rank pod mesh against the one-card step
pm = M.device_mesh(M.AbstractMesh(("pod", "data", "model"), (1, 1, 1)))
def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2), {}
g = torch.Generator().manual_seed(0)
params = {"w": torch.randn((3, 1), generator=g)}
batches = [{"x": torch.randn((2, 8, 3), generator=g), "y": torch.randn((2, 8, 1), generator=g)}
           for _ in range(3)]
opt = Adam(lr=lambda t: 1e-2)
plain = P.make_local_train_step(loss_fn, opt)
sharded = P.make_local_train_step(loss_fn, opt, mesh=pm)
s0 = P.stack_for_pods(params, 2)
o0 = P.init_pod_opt_state(opt, s0)
s1 = P.stack_for_pods(params, 2, pm)
o1 = P.init_pod_opt_state(opt, s1)
pod = (Replicate(),) * 3
same = []
for b in batches:
    _, _, l0 = plain(s0, o0, b)
    _, _, l1 = sharded(s1, o1, {k: distribute_tensor(v, pm, pod) for k, v in b.items()})
    same.append(torch.equal(l0, l1.full_tensor()))
out["local_losses_equal"] = same
out["local_params_equal"] = torch.equal(s0["w"], s1["w"].full_tensor())

# the zoo's train step over a (1, 1) mesh against the one-card step
cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), dtype="float32")
hm = M.make_host_mesh(device="cpu")
dm = M.device_mesh(hm)
opt = Adam(lr=one_cycle(3e-4, 4))
fn0, api, _ = build_train_step(cfg, opt, "cpu")
fn1, _, _ = build_train_step(cfg, opt, "cpu", mesh=dm)
p0 = api.init_params(R.PRNGKey(0))
o0 = opt.init(p0)
ps, os_, bs = sharded_train_inputs(cfg, InputShape("x", 32, 2, "train"),
                                   make_rules(hm, "train"), opt)
p1 = distribute_structs(ps, dm, pt.tree_map(lambda x: x.clone(), p0))
o1 = distribute_structs(os_, dm, pt.tree_map(lambda x: x.clone(), o0))
steps = []
for step in range(2):
    batch = make_batch(cfg, step, 2, 32, "cpu")
    _, _, m0 = fn0(p0, o0, batch)
    with cost.counting_collectives() as recs:
        _, _, m1 = fn1(p1, o1, distribute_structs(bs, dm, batch))
    differ = [path for (path, a), b in zip(pt.flatten_with_paths(p0), pt.leaves(p1))
              if not torch.equal(a, b.full_tensor())]
    steps.append({"loss": [float(m0["loss"]), float(m1["loss"].full_tensor())],
                  "loss_equal": torch.equal(m0["loss"], m1["loss"].full_tensor()),
                  "params_differ": differ, "collectives": len(recs)})
out["train"] = steps
dist.destroy_process_group()
print(json.dumps(out))
"""

_FOUR_RANKS_CHILD = r"""
import contextlib, dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.psgf_mix import ops as mix
from repro_torch.kernels.ssm_scan import ops as ssm
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch.api import distribute_structs
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step, sharded_train_inputs
from repro_torch.launch.train import make_batch
from repro_torch.optim import Adam
from repro_torch.sharding.rules import make_rules
from torch.distributed._tools.mem_tracker import MemTracker

store, rank = sys.argv[1], int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=4)
am = M.AbstractMesh(("data", "model"), (2, 2))
dm = M.device_mesh(am, "cpu")
R_ = Replicate()
out = {"train": {}, "kernels": {}, "peaks": {}}

def err(got, want):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    return float((got.detach() - want.detach()).abs().max())

# the zoo's train step on real shards against the plain step
for arch in ("qwen2-1.5b", "phi3.5-moe-42b-a6.6b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    # eps 1: the first updates are linear in the gradient, so a leaf whose
    # gradient is zero analytically (attn/bk) moves by float noise in both
    # steps, not by Adam's +-lr
    opt = Adam(lr=lambda t: 1e-3, eps=1.0)
    fn0, api, _ = build_train_step(cfg, opt, "cpu")
    fn1, _, _ = build_train_step(cfg, opt, "cpu", mesh=dm)
    p0 = api.init_params(R.PRNGKey(0))
    o0 = opt.init(p0)
    B, S = 4, 16
    ps, os_, bs = sharded_train_inputs(cfg, InputShape("x", S, B, "train"),
                                       make_rules(am, "train"), opt)
    p1 = distribute_structs(ps, dm, pt.tree_map(lambda x: x.clone(), p0))
    o1 = distribute_structs(os_, dm, pt.tree_map(lambda x: x.clone(), o0))
    steps = []
    for step in range(2):
        batch = make_batch(cfg, step, B, S, "cpu")
        _, _, m0 = fn0(p0, o0, batch)
        laid = distribute_structs(bs, dm, batch)
        with contextlib.ExitStack() as stack:
            if step == 0:
                # rank 0's peak on its real shards, the step's arguments
                # counted from the start
                tracker = MemTracker()
                tracker.track_external(p1, o1, laid)
                stack.enter_context(tracker)
            recs = stack.enter_context(cost.counting_collectives())
            _, _, m1 = fn1(p1, o1, laid)
        if step == 0:
            out["peaks"][arch] = sum(
                dev["Total"] for dev in tracker.get_tracker_snapshot("peak").values())
        steps.append({
            "loss": [float(m0["loss"]), float(m1["loss"].full_tensor())],
            "param_err": max(err(b, a) for a, b in zip(pt.leaves(p0), pt.leaves(p1))),
            "collectives": len(recs)})
    out["train"][arch] = {"steps": steps, "split_leaves": [
        path for path, st in pt.flatten_with_paths(ps)
        if any(e is not None for e in st.spec)]}

# the kernel wrappers on real shards against their plain versions
g = torch.Generator().manual_seed(0)
rand = lambda *shape: torch.randn(shape, generator=g)

def case(name, fn, inputs, placements):
    # fn on whole tensors and on DTensors laid out by placements: the
    # errors of the outputs and of the inputs' gradients (of a random
    # weighting of the outputs), the forward's collectives and layouts
    whole = [x.clone().requires_grad_() for x in inputs]
    want = fn(*whole)
    weights = [torch.randn(w.shape, generator=g) for w in want]
    sum(torch.sum(w * c) for w, c in zip(want, weights)).backward()
    laid = [distribute_tensor(x.clone(), dm, pl).requires_grad_()
            for x, pl in zip(inputs, placements)]
    with cost.counting_collectives() as recs:
        got = fn(*laid)
    sum(torch.sum(o * distribute_tensor(c, dm, [R_, R_]))
        for o, c in zip(got, weights)).backward()
    out["kernels"][name] = {
        "fwd_err": max(err(o, w) for o, w in zip(got, want)),
        "grad_err": max(err(l.grad, w.grad) for l, w in zip(laid, whole)),
        "collectives": len(recs),
        "in": [[str(p) for p in x.placements] for x in laid],
        "out": [[str(p) for p in o.placements] for o in got]}

BATCH_HEADS, SEQ = (Shard(0), Shard(2)), (Shard(1), R_)
flash = lambda q, k, v: (fa.flash_attention(q, k, v, causal=True),)
q, k, v = rand(4, 8, 4, 8), rand(4, 8, 2, 8), rand(4, 8, 2, 8)
case("flash_batch_heads", flash, (q, k, v), [BATCH_HEADS] * 3)
case("flash_one_kv_head", flash, (q, k[:, :, :1], v[:, :, :1]),
     [BATCH_HEADS, (Shard(0), R_), (Shard(0), R_)])
case("flash_sequence", flash, (q, k, v), [SEQ] * 3)
scan = lambda *a: ssm.ssm_scan(*a, return_state=True)
x, dt = rand(4, 8, 6), torch.nn.functional.softplus(rand(4, 8, 6))
bc = (rand(4, 8, 3), rand(4, 8, 3))
A = -torch.exp(0.1 * rand(6, 3))
case("ssm_batch_channels", scan, (x, dt, *bc, A),
     [BATCH_HEADS] * 2 + [(Shard(0), R_)] * 2 + [(R_, Shard(0))])
case("ssm_sequence", scan, (x, dt, *bc, A), [SEQ] * 4 + [(R_, R_)])
w_global, w_rows = rand(10), rand(4, 10)
mask = (torch.rand((4, 10), generator=g) < 0.5).float()
case("mix_rows_d", mix.psgf_mix_batch, (w_global, w_rows, mask),
     [(R_, Shard(0))] + [(Shard(0), Shard(1))] * 2)
case("mix_single_d", mix.psgf_mix, (w_global, w_rows[0], mask[0]), [(Shard(0), R_)] * 3)
# three rows do not split over two ranks
case("mix_uneven_rows", mix.psgf_mix_batch, (w_global, w_rows[:3], mask[:3]),
     [(R_, R_)] + [(Shard(0), R_)] * 2)
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""

# the reference's summaries of the accounting child's single ops: each op
# jitted with the same layouts on a (2, 2, 2) mesh of 8 XLA host devices, as
# ``repro.launch.dryrun`` compiles for its 512
_REFERENCE_CHILD = r"""
import json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch import hlo_analysis

mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
sh = lambda *spec: NamedSharding(mesh, P(*spec))
cases = {
    "dot_rows": (lambda x, w: x @ w, [((64, 32), sh("data")), ((32, 48), sh())], sh("data")),
    "dot_contract": (lambda x, w: x @ w, [((64, 32), sh(None, "model")),
                                          ((32, 48), sh("model"))], sh()),
    "exp": (jnp.exp, [((64, 32), sh("data", "model"))], sh("data", "model")),
    "tanh": (jnp.tanh, [((64, 32), sh("data", "model"))], sh("data", "model")),
    "row_sum": (lambda x: x.sum(axis=1), [((64, 32), sh("data"))], sh("data")),
}
out = {}
for name, (fn, ins, out_sharding) in cases.items():
    args = [jax.ShapeDtypeStruct(shape, jnp.float32, sharding=s) for shape, s in ins]
    compiled = jax.jit(fn, out_shardings=out_sharding).lower(*args).compile()
    out[name] = {"cost": hlo_analysis.cost_summary(compiled),
                 "memory": hlo_analysis.memory_summary(compiled)}
print(json.dumps(out))
"""

_CHILDREN = {"accounting": _ACCOUNTING_CHILD, "steps": _STEPS_CHILD,
             "one_rank": _ONE_RANK_CHILD, "reference": _REFERENCE_CHILD}
FOUR_RANKS = 4
_REPORTS = {}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Starts the children together (the four ranks of the gloo group
    among them) and returns their reports (rank 0's for the group)."""
    if not _REPORTS:
        tmp = tmp_path_factory.mktemp("gloo")
        env = child_env({"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
        argv = {name: [code] + ([str(tmp / "store")] if name == "one_rank" else [])
                for name, code in _CHILDREN.items()}
        argv.update({f"four_ranks/{r}": [_FOUR_RANKS_CHILD, str(tmp / "store4"), str(r)]
                     for r in range(FOUR_RANKS)})
        reference_env = dict(env, JAX_PLATFORMS="cpu",
                             XLA_FLAGS="--xla_force_host_platform_device_count=8")
        procs = {name: subprocess.Popen(
            [sys.executable, "-c"] + args,
            env=reference_env if name == "reference" else env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name, args in argv.items()}
        try:
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, f"{name} child failed:\n{err[-4000:]}"
                if name in _CHILDREN or name == "four_ranks/0":
                    _REPORTS[name.split("/")[0]] = json.loads(out.strip().splitlines()[-1])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return _REPORTS


def _groups(axis):
    """The (2, 2, 2) mesh's groups along ``axis``, as HLO replica groups."""
    return {"model": "{{0,1},{2,3},{4,5},{6,7}}",
            "pod": "{{0,4},{1,5},{2,6},{3,7}}"}[axis]


_HLO = {
    "all-reduce": "%r = {t}[16,8]{{1,0}} all-reduce({t}[16,8]{{1,0}} %x), replica_groups={g}",
    "all-gather": "%r = {t}[16,4]{{1,0}} all-gather({t}[8,4]{{1,0}} %x), replica_groups={g}, dimensions={{0}}",
    "reduce-scatter": "%r = {t}[8,4]{{1,0}} reduce-scatter({t}[16,4]{{1,0}} %x), replica_groups={g}, dimensions={{0}}",
    "all-to-all": "%r = {t}[8,4]{{1,0}} all-to-all({t}[8,4]{{1,0}} %x), replica_groups={g}, dimensions={{0}}",
}


@pytest.mark.parametrize("axis", ["model", "pod"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(_HLO))
def test_bytes_and_cross_pod_equal_the_reference_parser(reports, op, axis, dtype):
    """One functional collective over an in-pod (``model``) or the ``pod``
    axis of a (2, 2, 2) fake mesh: the port's dict equals the reference's
    ``collective_bytes(line, pod_size=4)`` on the HLO line of the same op,
    result shape and replica groups (the cases of ``tests/test_launch.py``'s
    parser and classifier tests)."""
    from repro.launch import hlo_analysis

    got = reports["accounting"]["ops"][f"{op}|{axis}|{dtype}"]
    line = _HLO[op].format(t={"float32": "f32", "bfloat16": "bf16"}[dtype],
                           g=_groups(axis))
    want = hlo_analysis.collective_bytes(line, pod_size=4)
    assert got == want
    assert (got["cross_pod"] == got["total"]) == (axis == "pod")


def test_accounting_group_refuses_to_replace_a_default_group(reports):
    assert "exists already" in reports["accounting"]["nested"]
    assert "exists already" in reports["one_rank"]["refused"]
    # and the accounting group is gone when its block ends
    assert reports["accounting"]["after"] is False


def test_all_to_all_on_the_cpu_mesh_counts_as_all_to_all(reports):
    """DTensor's Shard(0) -> Shard(1) over ``model`` falls back to an
    all-gather and a chunk on a CPU mesh; it is counted as the all-to-all
    it stands for, with a real all-to-all's result bytes (its input's)."""
    got = reports["accounting"]["redistribute"]
    assert got == {"all-to-all": 4 * 8 * 4, "total": 4 * 8 * 4, "count": 1,
                   "cross_pod": 0.0}


def test_static_sync_sends_exactly_the_shared_leaves_across_pods(reports):
    """``psgf_sync_static`` over pod-split DTensors: an unshared leaf makes
    no collective (the reference's ``test_engine.py`` HLO check), a shared
    leaf one all-reduce over ``pod`` of twice its bytes, a forwarded one
    none; ``full_sync`` twice every leaf's; all of it across pods."""
    syncs = reports["accounting"]["syncs"]
    leaf = reports["accounting"]["leaf_bytes"]
    assert reports["accounting"]["pod_split"] == [True, False, False]
    assert reports["accounting"]["global_whole"] == [True, True, True]
    assert syncs["unshared"] == {"total": 0, "count": 0, "cross_pod": 0}
    shared = 2.0 * leaf["a"]
    for name in ("shared_a", "shared_a_forward_b"):
        assert syncs[name] == {"all-reduce": shared, "total": shared, "count": 1,
                               "cross_pod": shared}
    full = 2.0 * (leaf["a"] + leaf["b"])
    assert syncs["full"] == {"all-reduce": full, "total": full, "count": 2,
                             "cross_pod": full}
    # the traced-gate sync touches every leaf: one all-reduce each at least
    assert syncs["traced"]["cross_pod"] == syncs["traced"]["total"] >= full


def test_local_step_on_a_pod_mesh_makes_no_collective(reports):
    """The reference's ``test_psgf_dp.py`` HLO check: pods are independent
    between syncs."""
    assert reports["accounting"]["local_step"] == {"total": 0, "count": 0,
                                                   "cross_pod": 0}


def test_local_step_on_a_one_rank_group_is_the_one_card_step(reports):
    rep = reports["one_rank"]
    assert rep["local_losses_equal"] == [True, True, True]
    assert rep["local_params_equal"]


def test_every_shard_shape_is_the_structs(reports):
    """All ten configs' params on both production meshes, laid out as meta
    DTensors: each rank-0 shard has ``ShardedStruct.shard_shape``."""
    rep = reports["accounting"]
    assert rep["bad_shards"] == []
    assert rep["leaves"] > 200


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_sharded_train_step_count_fits_over_depth(reports, arch):
    """Reduced qwen2 and phi3.5-moe train steps over a (2, 2, 2) fake mesh
    at depth 4: the dry run's fit from depths 2 and 3 (the forward and
    backward fitted, each phase's peak on its own, the update counted at
    depth 4) equals the direct count of the whole step in FLOPs, bytes
    accessed, transcendentals, argument / output / alias bytes, the
    forward's and the update's peaks, the step's peak, and the
    collectives' dict, which has the reference's keys. The backward's peak
    is the largest of the peaks of ops whose live bytes grow with the depth
    at different rates, so a fit through two depths is at most the count
    (the largest of affine functions is convex): at depth 4 reduced qwen2's
    backward already peaks in another op than at depths 2 and 3."""
    rep = reports["steps"][arch]
    fit, direct = rep["fit"], rep["direct"]
    assert [p["depths"]["num_layers"] for p in fit["extrapolated"]["points"]] == [2, 3]
    assert "extrapolated" not in direct
    fit_peaks, direct_peaks = fit.pop("peak_by_phase"), direct.pop("peak_by_phase")
    assert {k: v for k, v in fit.items() if k != "extrapolated"} == direct
    assert fit_peaks["forward"] == direct_peaks["forward"]
    assert fit_peaks["after"] == direct_peaks["after"] == direct["peak_bytes"]
    assert fit_peaks["backward"] <= direct_peaks["backward"]
    coll = direct["collectives"]
    assert set(coll) <= REFERENCE_KEYS
    assert 0 < coll["cross_pod"] < coll["total"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert set(direct_peaks) == {"forward", "backward", "after"}
    assert direct["peak_bytes"] == max(direct_peaks.values())
    assert direct["alias_bytes"] > 0 and direct["bytes_accessed"] > direct["peak_bytes"]
    # as many collectives as torch's CommDebugMode sees in the same step
    assert rep["depth1"] == rep["comm_debug_depth1"] > 0


def test_train_step_on_a_one_rank_mesh_is_the_plain_step(reports):
    """Reduced qwen2 (float32) through ``build_train_step(mesh=...)`` on a
    real one-rank gloo group: losses bitwise the plain step's, no
    collective counted (every group has one rank). After the first update
    every param is bitwise equal but the ``attn/bk`` leaf, whose gradient
    is zero analytically and float noise in either step (ROADMAP Queue C's
    caveat); the second step's loss is bitwise equal too."""
    first, second = reports["one_rank"]["train"]
    assert first["loss_equal"] and second["loss_equal"], (first, second)
    assert first["params_differ"] in ([], ["blocks/attn/bk"])
    assert first["collectives"] == second["collectives"] == 0


_CARD_CHILD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist

from repro_torch import random as R
from repro_torch.common import pytree_utils as pt
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import cost
from repro_torch.launch import mesh as M
from repro_torch.launch.api import distribute_structs
from repro_torch.launch.shapes import InputShape
from repro_torch.launch.steps import build_train_step, sharded_train_inputs
from repro_torch.launch.train import make_batch
from repro_torch.optim import Adam, one_cycle
from repro_torch.sharding.rules import make_rules

torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[1], rank=0, world_size=1)
cfg = get_config("qwen2-1.5b").reduced()
hm = M.make_host_mesh(device="cuda")
dm = M.device_mesh(hm, "cuda")
opt = Adam(lr=one_cycle(3e-4, 4))
B, S = 4, 128
out = {}
for name, mesh in (("plain", None), ("sharded", dm)):
    fn, api, _ = build_train_step(cfg, opt, "cuda", mesh=mesh)
    params = api.init_params(R.PRNGKey(0))
    state = opt.init(params)
    if mesh is not None:
        ps, os_, bs = sharded_train_inputs(cfg, InputShape("x", S, B, "train"),
                                           make_rules(hm, "train"), opt)
        params, state = distribute_structs(ps, dm, params), distribute_structs(os_, dm, state)
    losses, recs = [], []
    fa.reset_launch_counts()
    for step in range(2):
        batch = make_batch(cfg, step, B, S, "cuda")
        if mesh is not None:
            batch = distribute_structs(bs, dm, batch)
        with cost.counting_collectives() as got:
            _, _, m = fn(params, state, batch)
        recs += got
        loss = m["loss"].full_tensor() if mesh is not None else m["loss"]
        losses.append(float(loss))
    torch.cuda.synchronize()
    out[name] = {"losses": losses, "tc": fa.ROUTE_LAUNCHES["tensor_core"],
                 "launches": fa.LAUNCHES,
                 "collectives": cost.summarize_collectives(recs)}
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_sharded_train_step_on_the_card_runs_the_kernels(tmp_path):
    """``chip_smoke.py`` phase 14 (a) at reduced size: the (1, 1) mesh's
    DTensor step over a one-rank NCCL group against the plain step, bf16:
    losses within 1e-5, the same tensor-core flash launches, no bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    env = child_env()
    proc = subprocess.run([sys.executable, "-c", _CARD_CHILD, str(tmp_path / "store")],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, sharded = rep["plain"], rep["sharded"]
    assert max(abs(a - b) for a, b in zip(plain["losses"], sharded["losses"])) <= 1e-5
    assert sharded["tc"] == plain["tc"] == plain["launches"] > 0
    assert sharded["collectives"]["total"] == 0


def test_serve_steps_on_a_mesh_take_the_serve_rules(reports):
    """``build_prefill_step`` / ``build_serve_step`` with a mesh return the
    serve rules on it (the ones the dry run lays their inputs out by), and
    their steps run over those inputs, issuing collectives; without a mesh
    they return no rules."""
    serve = reports["accounting"]["serve"]
    for kind in ("prefill", "decode"):
        assert serve[kind]["rules"] and serve[kind]["total"] > 0, serve
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    cfg = get_config("qwen2-1.5b").reduced()
    assert build_prefill_step(cfg, "meta")[2] is None
    assert build_serve_step(cfg, "meta")[2] is None


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_train_step_on_four_ranks_matches_the_plain_step(reports, arch):
    """Reduced qwen2 and phi3.5-moe (float32) through
    ``build_train_step(mesh=...)`` on a (2, 2) ``data`` x ``model`` mesh of
    four gloo ranks, every shard real: the FSDP and head splits, the
    vocab-parallel embedding and loss, the expert split and their
    gradients. Two steps' losses and updated params against the plain
    step on whole tensors, within float32 rounding."""
    rep = reports["four_ranks"]["train"][arch]
    # the rules split the weights over both axes
    assert len(rep["split_leaves"]) >= 9, rep["split_leaves"]
    assert "embed/embedding" in rep["split_leaves"]
    for step in rep["steps"]:
        plain, sharded = step["loss"]
        assert abs(plain - sharded) <= 1e-6 * abs(plain), step
        assert step["param_err"] <= 1e-6, step
        assert step["collectives"] > 0


@pytest.mark.parametrize("case", ["flash_batch_heads", "flash_one_kv_head",
                                  "ssm_batch_channels", "mix_rows_d",
                                  "mix_single_d"])
def test_kernel_wrappers_keep_batch_and_head_splits_local(reports, case):
    """A kernel wrapper given DTensors split where its op stays local
    (flash: batch and heads, or batch with one kv head; ssm_scan: batch
    and channels; psgf_mix: rows and D) runs on each rank's shards: no
    collective, the outputs split as the inputs, the outputs and the
    inputs' gradients those of the whole call (four gloo ranks)."""
    rep = reports["four_ranks"]["kernels"][case]
    assert rep["collectives"] == 0, rep
    # laid out as q, x, or psgf_mix's rows
    assert rep["out"][0] == rep["in"][1 if case.startswith("mix") else 0], rep
    assert rep["fwd_err"] <= 1e-6 and rep["grad_err"] <= 1e-5, rep


@pytest.mark.parametrize("case", ["flash_sequence", "ssm_sequence",
                                  "mix_uneven_rows"])
def test_kernel_wrappers_make_other_splits_whole_and_count_it(reports, case):
    """A split the op cannot keep local (a sequence split, rows that do
    not divide) is made whole first, by collectives that are counted; the
    results are the whole call's."""
    rep = reports["four_ranks"]["kernels"][case]
    assert rep["collectives"] > 0, rep
    assert all(p == ["R", "R"] for p in rep["out"]), rep
    assert rep["fwd_err"] <= 1e-6 and rep["grad_err"] <= 1e-5, rep


def test_spec_to_placements():
    """One placement per mesh axis: ``Shard(d)`` on each axis of a
    dimension's entry (a tuple in the mesh's order only), ``Replicate()``
    elsewhere and on an axis of size 1."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import spec_to_placements

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert spec_to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_to_placements(("model",), mesh) == (Replicate(), Replicate(), Shard(0))
    assert spec_to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        spec_to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="not in"):
        spec_to_placements(("clients",), mesh)
    one_card = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    assert spec_to_placements(("data", "model"), one_card) == (Replicate(),) * 2


# where the reference's counts differ from the port's by definition: XLA
# counts a flop for each element an all-reduce or a reduction adds (the
# contracting split's all-reduce of the 64 x 48 result; the row sum's 31
# adds per row of 32, 32 rows a device), where the port counts matmul FLOPs
# only; and XLA's reduce reads its 4-byte init value as an operand
XLA_ELEMENTWISE_FLOPS = {"dot_contract": 64 * 48, "row_sum": 32 * 31}
XLA_REDUCE_INIT_BYTES = {"row_sum": 4}


@pytest.mark.parametrize("case", ["dot_rows", "dot_contract", "exp", "tanh", "row_sum"])
def test_single_op_counts_equal_the_reference_summaries(reports, case):
    """One op over DTensors on a (2, 2, 2) fake mesh against the
    reference's ``cost_summary`` and ``memory_summary`` of the same op,
    jitted with the same layouts on 8 XLA host devices: flops,
    transcendentals, bytes accessed (a dot, its all-reduce, elementwise
    ops, a reduction: nothing XLA fuses or re-lays out), argument and
    output bytes per device, no alias; the differences by definition are
    the named constants above."""
    mine = reports["accounting"]["single_ops"][case]
    ref = reports["reference"][case]
    assert mine["flops"] + XLA_ELEMENTWISE_FLOPS.get(case, 0) == ref["cost"].get("flops", 0)
    assert mine["transcendentals"] == ref["cost"].get("transcendentals", 0)
    assert mine["bytes_accessed"] + XLA_REDUCE_INIT_BYTES.get(case, 0) == (
        ref["cost"]["bytes_accessed"])
    assert mine["argument_bytes"] == ref["memory"]["argument_size_in_bytes"]
    assert mine["output_bytes"] == ref["memory"]["output_size_in_bytes"]
    assert mine["alias_bytes"] == ref["memory"]["alias_size_in_bytes"] == 0


def test_one_by_one_mesh_counts_are_the_one_device_step(reports):
    """Reduced qwen2's train step over DTensors on a (1, 1) mesh: its
    per-device FLOPs are the global count exactly, and its per-device
    peak is within 1% of ``one_device_peak`` of the same step (equal at
    this size)."""
    one = reports["accounting"]["one_by_one"]
    assert one["flops"] == one["flops_global"] > 0
    assert abs(one["peak"] - one["one_device_peak"]) <= 0.01 * one["one_device_peak"]


def test_record_holds_the_reference_summaries_per_device(reports):
    """A whole record on 2 x 16 x 16 (reduced qwen2, train_4k): memory and
    cost in the reference's keys, per device; the roofline from the
    counted FLOPs and bytes accessed."""
    from repro_torch.common import hw

    rec = reports["accounting"]["record"]
    memory, counted, roof = rec["memory"], rec["cost"], rec["roofline"]
    args = memory["argument_size_in_bytes"]
    assert args == memory["argument_bytes"]["total"] > 0
    assert memory["temp_size_in_bytes"] == memory["peak_bytes"] - args > 0
    assert memory["peak_bytes"] == max(memory["peak_by_phase"].values())
    # the params and moments are updated in place: outputs that are arguments
    assert 0 < memory["alias_size_in_bytes"] < memory["output_size_in_bytes"]
    assert memory["alias_size_in_bytes"] == (memory["argument_bytes"]["params"]
                                             + memory["argument_bytes"]["opt_state"])
    assert memory["fits_hbm"] == (memory["peak_bytes"] <= hw.HBM_BYTES)
    assert counted["flops"] > 0 and counted["transcendentals"] > 0
    assert counted["bytes_accessed"] > memory["peak_bytes"]
    assert "flops_per_device_ideal" not in counted and counted["flops_global"] > 0
    assert roof["compute_s"] == pytest.approx(counted["flops"] / hw.BF16_FLOP_PER_S)
    assert roof["memory_s"] == pytest.approx(counted["bytes_accessed"] / hw.HBM_BYTES_PER_S)
    assert rec["collectives"]["cross_pod"] > 0


# the fake-group estimate against rank 0's MemTracker peak on its real
# shards: the same ops on the same shard shapes; MemTracker counts each
# CPU storage's bytes as the counter does
FOUR_RANK_PEAK_RTOL = 0.01


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_four_rank_peak_matches_the_fake_group_estimate(reports, arch):
    """Reduced qwen2 and phi3.5-moe (float32) on the (2, 2) mesh: rank 0's
    peak while its first sharded step runs on four gloo ranks with real
    tensors (``MemTracker``, arguments counted from the start) against the
    dry run's per-device peak of the same step on the fake group."""
    measured = reports["four_ranks"]["peaks"][arch]
    estimate = reports["accounting"]["four_rank_estimates"][arch]
    assert abs(measured - estimate) <= FOUR_RANK_PEAK_RTOL * measured, (measured, estimate)
