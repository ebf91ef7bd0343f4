"""PyTorch/CUDA port of the PSGF-Fed forecasting system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and layout (``repro_torch.core.forecast`` is the counterpart of
``repro.core.forecast``, and so on) and imports ``torch`` and ``numpy``, never
``jax`` and nothing of ``repro``.

Ported so far, both halves of the paper's main path:

  * training — ``repro_torch.core.tasks.run_experiment``: DTW clustering of
    the stations, PSGF-Fed per cluster (``repro_torch.core.fl``: masks,
    policies and the engine with the ``loop``, ``scan``, ``while``
    (CUDA-graph chunks) and ``host`` (pinned host client store) drivers,
    every random draw from ``repro_torch.random``, a bit-exact threefry), a
    checkpoint per cluster and the routing manifest. With
    ``FLConfig.use_pallas_mix`` the downlink runs the hand-written CUDA
    kernel ``repro_torch/csrc/psgf_mix.cu``;
  * serving — ``repro_torch.launch.serve_forecast.ForecastServer
    .from_manifest`` restores the per-cluster checkpoints and serves them
    through bucketed micro-batching; with ``use_flash_attn=True`` the
    forecaster's attention block runs ``repro_torch/csrc/flash_attention.cu``
    (in training too, under ``torch.func.vmap(grad)``);
  * the loop between them — ``repro_torch.core.fl.flywheel``
    (``DriftDetector``, ``RetrainController``) retrains a drifted cluster and
    publishes the next manifest generation, which the server hot-swaps, and
    ``repro_torch.launch.gateway`` serves it over HTTP; on the card a
    retrain (the while driver's CUDA-graph capture included) and serving
    share one GPU, each on its own stream.

Importing this package (or any subpackage) imports nothing heavier than
``torch``: kernels are compiled and loaded at their first launch.
"""
