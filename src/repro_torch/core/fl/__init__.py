from repro_torch.core.fl.masks import (
    bernoulli_mask, client_masks, exact_k_mask, leaf_gates, select_clients,
    topk_mask,
)
from repro_torch.core.fl.policies import (
    OnlineFed, PSGFFed, PSGFTopK, PSOFed, Policy, from_config,
)
from repro_torch.core.fl.engine import (
    ACCOUNTING_DTYPE, FL_PARITY_TOL, FLConfig, aggregate, evaluate_rmse,
    fl_round, gate_bytes, gate_count, init_fl_state, mix_down, mix_down_count,
    quantize_wire_vec, run_fl, sample_cohort, wire_scale_count,
)
from repro_torch.core.fl.client_store import ClientStore, run_fl_host
from repro_torch.core.fl.flywheel import DriftDetector, RetrainController
