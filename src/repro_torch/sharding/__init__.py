from repro_torch.sharding.rules import (  # noqa: F401
    FL_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    ShardingRules,
    logical_to_sharding,
    logical_to_spec,
    make_rules,
    shard_shape,
)
