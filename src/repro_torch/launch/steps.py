"""Step builders of a zoo model (counterpart of ``repro.launch.steps``): the
optimizer, the train step, the prefill and decode (serve) steps, the
shardings of params and optimizer state, and the abstract sharded inputs of
the dry run (``launch.dryrun``).

The reference jits each step with explicit shardings for a mesh. One card
runs the whole model, so the prefill and decode builders take no mesh: the
specs of ``sharding.rules`` are recorded (``param_shardings``,
``sharded_*_inputs``), not applied. Laying them out as DTensor placements
over a real ``DeviceMesh``, with the reference's ``context_parallel`` and
rule overrides of the serve step, needs several GPUs in one process
(ROADMAP Queue A 11).
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
from repro_torch.sharding.rules import ShardingRules, logical_to_sharding


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


def build_train_step(cfg: ModelConfig, optimizer=None, device=DEFAULT_DEVICE):
    """Returns ``(fn, api, optimizer)`` where ``fn(params, opt_state, batch)
    -> (params, opt_state, metrics)`` takes one step: forward, backward and
    the optimizer's update written into ``params`` and ``opt_state`` (the
    reference donates both to its jitted step). ``metrics`` holds the
    loss function's metrics and ``loss``."""
    api = ModelApi(cfg, device)
    optimizer = optimizer or make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = pt.value_and_grad(api.loss_fn, params, batch)
        with record_function("train.optimizer"):
            optimizer.update_(params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step, api, optimizer


def abstract_opt_state(api: ModelApi, optimizer):
    """The optimizer's state for the abstract params, as ``meta`` tensors."""
    return optimizer.init(api.abstract_params())


def build_prefill_step(cfg: ModelConfig, device=DEFAULT_DEVICE):
    """Returns ``(fn, api)`` where ``fn(params, batch, cache_len=None) ->
    (logits of the last position, cache)``."""
    api = ModelApi(cfg, device)
    return api.prefill, api


def build_serve_step(cfg: ModelConfig, device=DEFAULT_DEVICE):
    """Returns ``(fn, api)`` where ``fn(params, cache, token, pos) ->
    (logits, cache)`` decodes one token, the cache updated in place (the
    reference donates it)."""
    api = ModelApi(cfg, device)
    return api.decode_step, api


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
