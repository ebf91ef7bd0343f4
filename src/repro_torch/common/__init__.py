from repro_torch.common.pytree_utils import (
    count_params,
    tree_size_bytes,
    tree_flatten_to_vector,
    tree_unflatten_from_vector,
    tree_zeros_like,
    tree_add,
    tree_scale,
)
from repro_torch.common import hw
