"""PyTorch/CUDA port of the PSGF-Fed forecasting system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and layout (``repro_torch.core.forecast`` is the counterpart of
``repro.core.forecast``, and so on) and imports ``torch`` and ``numpy``, never
``jax`` and nothing of ``repro``.

Ported so far: the serving path. A per-cluster forecaster checkpoint plus the
generational routing manifest are restored by
``repro_torch.launch.serve_forecast.ForecastServer.from_manifest`` and served
through bucketed micro-batching; with ``use_flash_attn=True`` the forecaster's
attention block runs the hand-written CUDA kernel in
``repro_torch/csrc/flash_attention.cu``.

Importing this package (or any subpackage) imports nothing heavier than
``torch``: kernels are compiled and loaded at their first launch.
"""
