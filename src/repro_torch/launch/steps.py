"""Step builders of a zoo model (counterpart of ``repro.launch.steps``): the
optimizer, the train step, the prefill and decode (serve) steps, the
shardings of params and optimizer state, and the abstract sharded inputs of
the dry run (``launch.dryrun``).

The reference jits each step with explicit shardings for a mesh. Here a
builder given a ``DeviceMesh`` (``launch.mesh.device_mesh``) returns a step
over DTensors: it takes the inputs that ``sharded_*_inputs`` and
``launch.api.distribute_structs`` lay out by the rules' specs, runs the
model's ops under DTensor's sharding rules (a plain tensor meets them as a
replicated one: ``implicit_replication``, here and nowhere else), and
issues the collectives they need: on a ``fake`` group they are counted
(``launch.cost.collective_bytes``), on devices they run. Without a mesh
each builder returns the one-card step, unchanged. A ``DeviceMesh`` takes
one process a device: ``launch.train`` and ``launch.serve`` build these
steps on ``launch.mesh.make_host_mesh`` over an initialized group (one
process a GPU over NCCL, or CPU processes over gloo).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.launch.api import (ModelApi, input_specs, model_module,
                                    with_shardings)
from repro_torch.launch.shapes import InputShape
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import spec_num_params
from repro_torch.optim import Adam, cosine_decay
from repro_torch.sharding.rules import (ShardingRules, logical_to_sharding,
                                        make_rules)


def param_shardings(api: ModelApi, rules: ShardingRules):
    """Each parameter's ``(spec, shard shape)`` on ``rules.mesh``."""
    return logical_to_sharding(api.param_axes(), rules, api.abstract_params())


def opt_shardings(p_shardings):
    """Adam's moments shard as the params; its step count is replicated."""
    return {"m": p_shardings, "v": p_shardings, "t": ((), ())}


def make_optimizer(cfg: ModelConfig, total_steps: int = 10000):
    """Adam with a cosine schedule; bf16 moments above 20B params."""
    n = spec_num_params(model_module(cfg).model_spec(cfg))
    moment_dtype = "bfloat16" if n > 20e9 else "float32"
    return Adam(lr=cosine_decay(3e-4, total_steps, warmup=200),
                moment_dtype=moment_dtype)


def _on_mesh(fn, mesh):
    """``fn`` run under ``implicit_replication`` (for DTensor inputs over
    ``mesh``), or ``fn`` itself without a mesh."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import implicit_replication

    def on_mesh(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)

    return on_mesh


def build_train_step(cfg: ModelConfig, optimizer=None, device=DEFAULT_DEVICE,
                     mesh=None):
    """Returns ``(fn, api, optimizer)`` where ``fn(params, opt_state, batch)
    -> (params, opt_state, metrics)`` takes one step: forward, backward and
    the optimizer's update written into ``params`` and ``opt_state`` (the
    reference donates both to its jitted step). ``metrics`` holds the
    loss function's metrics and ``loss``.

    With ``mesh`` (a ``DeviceMesh``) the arguments are DTensors laid out by
    the train rules; each gradient is laid out as its parameter (the
    reduce-scatter or all-reduce of data parallelism) before the update.

    ``fn`` is the composition of its two halves, which it carries as
    attributes for the dry run (``launch.dryrun``) to count apart:
    ``fn.gradients(params, batch) -> (grads, metrics)`` (``metrics`` with
    ``loss``) and ``fn.apply_gradients(params, grads, opt_state) ->
    (params, opt_state)``, which lays each gradient out as its parameter in
    ``grads`` itself, leaf by leaf (the old layout freed as it goes), then
    updates in place."""
    api = ModelApi(cfg, device)
    optimizer = optimizer or make_optimizer(cfg)

    def gradients(params, batch):
        (loss, metrics), grads = pt.value_and_grad(api.loss_fn, params, batch)
        return grads, dict(metrics, loss=loss)

    def apply_gradients(params, grads, opt_state):
        if mesh is not None:
            _lay_out_as(grads, params)
        with record_function("train.optimizer"):
            optimizer.update_(params, grads, opt_state)
        return params, opt_state

    def train_step(params, opt_state, batch):
        grads, metrics = gradients(params, batch)
        apply_gradients(params, grads, opt_state)
        return params, opt_state, metrics

    fn = _on_mesh(train_step, mesh)
    fn.gradients = _on_mesh(gradients, mesh)
    fn.apply_gradients = _on_mesh(apply_gradients, mesh)
    return fn, api, optimizer


def _lay_out_as(grads, params):
    """Each DTensor gradient of the (nested dict) tree ``grads`` laid out
    as its parameter, replaced in ``grads`` one leaf at a time."""
    for key, g in grads.items():
        if isinstance(g, dict):
            _lay_out_as(g, params[key])
        else:
            grads[key] = g.redistribute(params[key].device_mesh, params[key].placements)


def abstract_opt_state(api: ModelApi, optimizer):
    """The optimizer's state for the abstract params, as ``meta`` tensors."""
    return optimizer.init(api.abstract_params())


def build_prefill_step(cfg: ModelConfig, device=DEFAULT_DEVICE, mesh=None):
    """Returns ``(fn, api, rules)`` where ``fn(params, batch, cache_len=None)
    -> (logits of the last position, cache)``; with ``mesh``, over DTensors
    laid out by ``rules``, the serve rules on it (None without a mesh)."""
    api = ModelApi(cfg, device)
    return _on_mesh(api.prefill, mesh), api, _serve_rules(mesh)


def build_serve_step(cfg: ModelConfig, device=DEFAULT_DEVICE, mesh=None,
                     rule_overrides: dict | None = None):
    """Returns ``(fn, api, rules)`` where ``fn(params, cache, token, pos) ->
    (logits, cache)`` decodes one token, the cache updated in place (the
    reference donates it); with ``mesh``, over DTensors laid out by
    ``rules``, the serve rules on it (None without a mesh). Whether the
    cache splits its batch or its sequence is the inputs' layout, which
    ``input_specs`` decides from the batch; the step is the same.

    ``rule_overrides={"embed": "data"}`` splits the weights over the data
    AND model axes at serve time, as the reference's does: the batch-1
    long-context shape, where the data axis would otherwise repeat every
    matmul."""
    api = ModelApi(cfg, device)
    return (_on_mesh(api.decode_step, mesh), api,
            _serve_rules(mesh, rule_overrides))


def _serve_rules(mesh, overrides=None):
    """The serve rules on a ``DeviceMesh`` (None without one), then
    ``overrides``."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import AbstractMesh

    abstract = AbstractMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return make_rules(abstract, "serve", overrides=overrides)


def sharded_train_inputs(cfg: ModelConfig, shape: InputShape, rules: ShardingRules,
                         optimizer, dtype=None):
    """Abstract ``(params, opt_state, batch)`` of a train step, each leaf a
    :class:`~repro_torch.launch.api.ShardedStruct`."""
    api = ModelApi(cfg, "meta")
    p_abs = api.abstract_params(dtype)
    p_sh = param_shardings(api, rules)
    o_abs = optimizer.init(p_abs)
    opt = with_shardings(o_abs, opt_shardings(p_sh))
    return with_shardings(p_abs, p_sh), opt, input_specs(cfg, shape, rules)


def sharded_serve_inputs(cfg: ModelConfig, shape: InputShape, rules: ShardingRules,
                         dtype=torch.bfloat16):
    """Abstract ``(params, inputs)`` of a prefill (the batch) or a decode
    step (``{cache, token, pos}``), each leaf a ``ShardedStruct``."""
    api = ModelApi(cfg, "meta")
    params = with_shardings(api.abstract_params(dtype), param_shardings(api, rules))
    return params, input_specs(cfg, shape, rules)
