"""The optimizer and the train step of a zoo model on one device
(counterpart of ``repro.launch.steps``).

The reference jits each step with explicit parameter and input shardings
for a mesh (``param_shardings``, ``opt_shardings``, ``sharded_*_inputs``)
and builds sharded prefill and decode steps for its dry-run. One card needs
no mesh: those wait for multi-GPU (ROADMAP Queue A item 7) and the launch
modules (item 9 (c)); serving calls ``ModelApi`` directly
(``launch.serve``).
"""
from __future__ import annotations

from torch.profiler import record_function

from repro_torch.common import pytree_utils as pt
from repro_torch.common.device import DEFAULT_DEVICE
from repro_torch.launch.api import ModelApi, model_module
from repro_torch.models.config import ModelConfig
from repro_torch.models.spec import spec_num_params
from repro_torch.optim import Adam, cosine_decay


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
