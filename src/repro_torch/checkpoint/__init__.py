from repro_torch.checkpoint.checkpoint import (
    atomic_write_bytes,
    atomic_write_json,
    latest_step,
    load_checkpoint,
    quantize_tree,
    read_manifest,
    save_checkpoint,
)
